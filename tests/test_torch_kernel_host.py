"""Host build of the fused kernel's body against its plain version.

``csrc/fused_iteration.cuh`` is plain C++ outside nvcc (``__host__`` and
``__device__`` are defined away). ``csrc/host_check.cc`` loops its
per-instance solve over the batch; it is compiled here with the system
``g++`` for ``T=double`` and held against
``ops/fused.py::fused_iteration_reference`` in f64 at a tiny size, to 1e-9,
with equal termination codes. Only the ``__global__`` wrapper of
``csrc/fused_iteration.cu`` is left to run first on the card.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

import cartpole_tpu_torch as pt
from cartpole_tpu_torch.models.params import SingleCartPoleParams
from cartpole_tpu_torch.mpc.lanes import _init_carry, _prepare
from cartpole_tpu_torch.ops import fused

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cartpole_tpu_torch", "csrc")
B = 4
CARRY = ("xs", "u", "lam", "mu", "merit", "done", "term", "fo")
TRACES = ("cost", "violation", "lambda", "alpha", "first_order", "applied")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("fused_host") / "libfused_host.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(out),
         os.path.join(CSRC, "host_check.cc")],
        check=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    lib.fused_iteration_host_f64.argtypes = [fused._Tensors, fused._ArgsD]
    lib.fused_iteration_host_f64.restype = ctypes.c_int
    return lib


def _x0(seed):
    rng = np.random.RandomState(seed)
    x0 = np.tile([0.0, np.pi / 2, 0.0, 0.0], (B, 1))
    x0[:, 0] += rng.uniform(-0.5, 0.5, B)
    x0[:, 1] += rng.uniform(-0.3, 0.3, B)
    x0[0] = [0.1, -np.pi / 2 + 0.2, 0.0, 0.0]
    return torch.as_tensor(x0)


def _problem(case):
    """(fused_solve args, initial carry) of one tiny f64 problem."""
    kw = dict(window_length=10, state_spacing=2, max_iterations=8)
    dp = pt.default_single_params(torch.float64, device="cpu")
    if case == "bench_window":
        kw.update(window_length=40, state_spacing=5)
    if case == "per_instance_params":
        dp = SingleCartPoleParams(**{
            **dp.as_dict(),
            "m_1": torch.tensor([0.08, 0.12, 0.08, 0.12], dtype=torch.float64),
            "l_1": torch.tensor([0.2, 0.2, 0.3, 0.3], dtype=torch.float64),
        })
    if case == "u_limit_40":
        kw.update(u_limit=40.0)
    mpc = pt.make_mpc(pt.OptimizationParams(**kw))
    x0 = _x0(7)
    st = pt.MPCState(torch.zeros((B, mpc.spec.dim), dtype=torch.float64),
                     torch.zeros((B,), dtype=torch.bool))
    if case == "warm":
        res = pt.run_closed_loop_lanes(mpc, x0, dp, 2, fused=True)
        x0, st = res.final_state, res.final_mpc_state
    problem, Z0 = _prepare(mpc, st, x0, dp, 0.1)
    args = (problem.statics.fused, dp, problem.x_current, problem.set_point,
            problem.u_prev)
    return args, _init_carry(Z0, mpc.nls_config), mpc.nls_config


def _host_solve(lib, args, carry, n_iter):
    ptrs, c, tr, keep = fused.kernel_io(*args, *carry, n_iter)
    rc = lib.fused_iteration_host_f64(
        ptrs, fused.kernel_args(args[0], B, n_iter, double=True))
    assert rc == 0
    del keep
    return c, tr


CASES = ("cold", "warm", "per_instance_params", "u_limit_40", "bench_window")


@pytest.fixture(scope="module")
def solves(host_lib):
    out = {}
    for case in CASES:
        args, carry, cfg = _problem(case)
        n = cfg.max_iterations
        out[case] = (_host_solve(host_lib, args, carry, n),
                     fused.fused_solve(*args, carry, n))
    return out


@pytest.mark.parametrize("case", CASES)
def test_carry_matches_plain_version(solves, case):
    (ck, _), (cp, _) = solves[case]
    for name, a, b in zip(CARRY, ck, cp):
        if name in ("done", "term"):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                       atol=1e-9, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_traces_match_plain_version(solves, case):
    (_, tk), (_, tp) = solves[case]
    for name, a, b in zip(TRACES, tk, tp):
        a, b = a.numpy().astype(float), b.numpy().astype(float)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
        m = ~np.isnan(a)
        np.testing.assert_allclose(a[m], b[m], rtol=1e-9, atol=1e-9,
                                   err_msg=name)


def test_cases_reach_early_termination(solves):
    """Some instances finish before the last iteration, so the frozen-carry
    path of the kernel runs."""
    applied = np.concatenate([solves[c][1][1][5].numpy().sum(0)
                              for c in CASES])
    assert applied.min() < 8 and applied.max() == 8


def test_one_iteration_launches_equal_one_launch(host_lib):
    args, carry, cfg = _problem("warm")
    c_all, t_all = _host_solve(host_lib, args, carry, cfg.max_iterations)
    c, rows = carry, []
    for _ in range(cfg.max_iterations):
        c, t = _host_solve(host_lib, args, c, 1)
        rows.append(t)
    for a, b in zip(c, c_all):
        assert torch.equal(a, b)
    for k in range(6):
        assert torch.equal(torch.cat([r[k] for r in rows]).nan_to_num(),
                           t_all[k].nan_to_num())
