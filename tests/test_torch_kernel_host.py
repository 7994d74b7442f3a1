"""Host build of the fused kernel's body against its plain version.

``csrc/fused_iteration.cuh`` is plain C++ outside nvcc (``__host__`` and
``__device__`` are defined away). ``csrc/host_check.cc`` runs it as the card
does: blocks of ``INSTANCES_PER_BLOCK`` instances that stage their statics
into a buffer laid out as shared memory, a ragged last block, and each
instance's stages run lane by lane over ``LANES_PER_INSTANCE`` lanes. It is
compiled here with the system ``g++`` for ``T=double`` and held against
``ops/fused.py::fused_iteration_reference`` in f64 at a tiny size, to 1e-9,
with equal termination codes, for the single model and for all-soft double
and triple problems (every terminal row a cost: 6 and 8 rows). Only the
``__global__`` wrapper of ``csrc/fused_iteration_launch.cuh`` is left to run
first on the card.
"""

import ctypes
import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

import cartpole_tpu_torch as pt
from cartpole_tpu_torch.models.params import SingleCartPoleParams
from cartpole_tpu_torch.mpc.lanes import _init_carry, _prepare
from cartpole_tpu_torch.ops import fused
from cartpole_tpu_torch.ops._build import build_host_library
from cartpole_tpu_torch.ops.pallas_kernels import KERNEL_MODELS

CARRY = ("xs", "u", "lam", "mu", "merit", "done", "term", "fo")
TRACES = ("cost", "violation", "lambda", "alpha", "first_order", "applied")
NO_TERMINAL_ROWS = dict(b_x_final_cost_weight=0.0, th_final_cost_weight=0.0,
                        b_x_dot_final_cost_weight=0.0,
                        th_dot_final_cost_weight=0.0)
#: The double- and triple-pole regime's terminal weights: all soft.
ALL_SOFT = dict(th_final_cost_weight=150.0, th_dot_final_cost_weight=10.0,
                b_x_dot_final_cost_weight=10.0)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    lib = ctypes.CDLL(build_host_library(
        str(tmp_path_factory.mktemp("fused_host")), gxx))
    lib.fused_iteration_host_f64.argtypes = [ctypes.c_int, fused._Tensors,
                                             fused._ArgsD, ctypes.c_int,
                                             ctypes.c_int]
    lib.fused_iteration_host_f64.restype = ctypes.c_int
    lib.fused_workspace_reals.argtypes = [ctypes.c_int] * 8
    lib.fused_workspace_reals.restype = ctypes.c_int
    lib.fused_statics_reals.argtypes = [ctypes.c_int]
    lib.fused_statics_reals.restype = ctypes.c_int
    return lib


def _x0(seed, B):
    rng = np.random.RandomState(seed)
    x0 = np.tile([0.0, np.pi / 2, 0.0, 0.0], (B, 1))
    x0[:, 0] += rng.uniform(-0.5, 0.5, B)
    x0[:, 1] += rng.uniform(-0.3, 0.3, B)
    x0[0] = [0.1, -np.pi / 2 + 0.2, 0.0, 0.0]
    return torch.as_tensor(x0)


def _multilink_x0(name, seed, B):
    """Near-upright states of the double or triple pole."""
    model = pt.get_model(name)
    rng = np.random.RandomState(seed)
    n_q = model.state_dim // 2
    x0 = np.zeros((B, model.state_dim))
    x0[:, 1:n_q] = np.pi / 2 + rng.uniform(-0.2, 0.2, (B, n_q - 1))
    x0[:, 0] = rng.uniform(-0.3, 0.3, B)
    x0[:, n_q + 1:] = rng.uniform(-0.5, 0.5, (B, n_q - 1))
    return torch.as_tensor(x0)


def _problem(case):
    """(fused_solve args, initial carry, config) of one tiny f64 problem.

    ``ragged_batch`` leaves the last block of instances part full,
    ``window_33`` has K beyond one pass of 32 lanes and not a multiple of
    it, ``no_terminal_rows`` has n_all = 0 (the other single cases have the
    default four terminal rows), ``frozen_at_start`` has two instances
    done before the first iteration, and ``double_all_soft`` and
    ``triple_all_soft`` are those models with every terminal row a cost,
    ``double_warm`` the double's after two ticks."""
    kw = dict(window_length=10, state_spacing=2, max_iterations=8)
    B = 4
    dp = pt.default_single_params(torch.float64, device="cpu")
    model, x0 = pt.SINGLE_CARTPOLE, None
    if case in ("double_all_soft", "double_warm", "triple_all_soft"):
        model = pt.get_model(case.split("_")[0])
        dp = model.params_type().to(torch.float64, "cpu")
        kw.update(ALL_SOFT, u_guess_sinusoid_amplitude=5.0)
        B = fused.INSTANCES_PER_BLOCK + 1
        x0 = _multilink_x0(model.name, 8, B)
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
    if case == "ragged_batch":
        B = 2 * fused.INSTANCES_PER_BLOCK + 1
    if case == "window_33":
        kw.update(window_length=33, state_spacing=3)
    if case == "no_terminal_rows":
        kw.update(NO_TERMINAL_ROWS)
    mpc = pt.make_mpc(pt.OptimizationParams(**kw), model)
    if x0 is None:
        x0 = _x0(7, B)
    st = pt.MPCState(torch.zeros((B, mpc.spec.dim), dtype=torch.float64),
                     torch.zeros((B,), dtype=torch.bool))
    if case in ("warm", "double_warm"):
        res = pt.run_closed_loop_lanes(mpc, x0, dp, 2, fused=True)
        x0, st = res.final_state, res.final_mpc_state
    problem, Z0 = _prepare(mpc, st, x0, dp, 0.1)
    args = (problem.statics.fused, dp, problem.x_current, problem.set_point,
            problem.u_prev)
    carry = _init_carry(Z0, mpc.nls_config)
    if case == "frozen_at_start":
        done, term = carry[5].clone(), carry[6].clone()
        done[1::2] = 1
        term[1::2] = 2
        carry = carry[:5] + (done, term) + carry[7:]
    return args, carry, mpc.nls_config


def _host_solve(lib, args, carry, n_iter, lanes=fused.LANES_PER_INSTANCE,
                instances=fused.INSTANCES_PER_BLOCK):
    ptrs, c, tr, keep = fused.kernel_io(*args, *carry, n_iter)
    B = carry[1].shape[-1]
    rc = lib.fused_iteration_host_f64(
        KERNEL_MODELS.index(args[0].model), ptrs,
        fused.kernel_args(args[0], B, n_iter, double=True), lanes,
        instances)
    assert rc == 0
    del keep
    return c, tr


CASES = ("cold", "warm", "per_instance_params", "u_limit_40", "bench_window",
         "ragged_batch", "window_33", "no_terminal_rows", "frozen_at_start",
         "double_all_soft", "double_warm", "triple_all_soft")


@pytest.fixture(scope="module")
def solves(host_lib):
    out = {}
    for case in CASES:
        args, carry, cfg = _problem(case)
        n = cfg.max_iterations
        out[case] = (_host_solve(host_lib, args, carry, n),
                     fused.fused_solve(*args, carry, n), (args, carry, n))
    return out


@pytest.mark.parametrize("case", CASES)
def test_carry_matches_plain_version(solves, case):
    (ck, _), (cp, _), _ = solves[case]
    for name, a, b in zip(CARRY, ck, cp):
        if name in ("done", "term"):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                       atol=1e-9, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_traces_match_plain_version(solves, case):
    (_, tk), (_, tp), _ = solves[case]
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


def test_cases_cover_the_shapes(solves):
    """The new cases reach what they are named for: a ragged last block,
    n_all = 0, K past one pass of 32 lanes, frozen instances."""
    st = {c: solves[c][2][0][0] for c in CASES}
    assert solves["ragged_batch"][2][1][1].shape[-1] % \
        fused.INSTANCES_PER_BLOCK != 0
    assert st["no_terminal_rows"].n_tc + st["no_terminal_rows"].n_t == 0
    assert st["cold"].n_tc + st["cold"].n_t == 4
    assert (st["double_all_soft"].n_tc, st["double_all_soft"].n_t) == (6, 0)
    assert (st["triple_all_soft"].n_tc, st["triple_all_soft"].n_t) == (8, 0)
    assert st["window_33"].K % 32 != 0 and st["window_33"].K > 32
    applied = solves["frozen_at_start"][1][1][5].numpy()
    assert (applied[:, 1::2] == 0).all() and (applied[0, 0::2] == 1).all()


@pytest.mark.parametrize("case", CASES)
def test_one_iteration_launches_equal_one_launch(host_lib, solves, case):
    args, carry, n_iter = solves[case][2]
    c_all, t_all = solves[case][0]
    c, rows = carry, []
    for _ in range(n_iter):
        c, t = _host_solve(host_lib, args, c, 1)
        rows.append(t)
    for a, b in zip(c, c_all):
        assert torch.equal(a, b)
    for k in range(6):
        assert torch.equal(torch.cat([r[k] for r in rows]).nan_to_num(),
                           t_all[k].nan_to_num())


@pytest.mark.parametrize("case", ["bench_window", "ragged_batch",
                                  "no_terminal_rows"])
def test_lane_counts_and_block_sizes_give_identical_results(host_lib, solves,
                                                           case):
    """Every output is computed whole by one lane, so 8, 16 or 32 lanes per
    instance (and so 1 to 5 line-search trials at a time) and any number of
    instances per block give the same bits."""
    args, carry, n_iter = solves[case][2]
    c_ref, t_ref = solves[case][0]
    for lanes, instances in ((8, 1), (16, 3), (32, 2)):
        c, t = _host_solve(host_lib, args, carry, n_iter, lanes, instances)
        for a, b in zip(c + t, c_ref + t_ref):
            assert torch.equal(a.nan_to_num(), b.nan_to_num())


def test_workspace_layout_matches_the_kernel(host_lib, solves):
    """``ops/fused.py``'s workspace and statics sizes, which size the
    launch and ``check_sizes``, are the kernel's own."""
    for case in CASES:
        st = solves[case][2][0][0]
        for lanes in (8, 16, 32):
            assert fused.workspace_reals(st, lanes) == \
                host_lib.fused_workspace_reals(
                    KERNEL_MODELS.index(st.model), st.K, st.N, st.S, st.n_u,
                    st.n_tc + st.n_t, st.n_ls, lanes)
        assert fused.statics_reals(st) == host_lib.fused_statics_reals(st.K)
    st = solves["bench_window"][2][0][0]
    assert fused.workspace_reals(st) * 4 < 8 * 1024
    w, smem = fused.block_shape(st)
    assert w == fused.INSTANCES_PER_BLOCK and smem <= fused.SMEM_BLOCK_MAX


def test_check_sizes_raises_where_shared_memory_runs_out(solves):
    """A window whose statics and one workspace exceed what a block may use
    raises with the sizes, before the range check."""
    st = solves["cold"][2][0][0]
    big = dataclasses.replace(st, K=240, N=49, S=48, n_u=480)
    ws, statics = 4 * fused.workspace_reals(big), 4 * fused.statics_reals(big)
    assert statics + ws > fused.SMEM_BLOCK_MAX
    with pytest.raises(ValueError, match=f"statics take {statics} B and one "
                       f"instance's workspace {ws} B, above the "
                       f"{fused.SMEM_BLOCK_MAX} B"):
        fused.check_sizes(big)
    fused.check_sizes(st)


def test_model_ids_name_kernel_models(host_lib, monkeypatch):
    """The library's model ids name KERNEL_MODELS in order; a table that
    lists the models in another order is refused at load."""
    from cartpole_tpu_torch.ops import _build

    _build.check_models(host_lib)
    monkeypatch.setattr(_build, "KERNEL_MODELS", ("double", "single",
                                                  "triple"))
    with pytest.raises(RuntimeError, match="model ids"):
        _build.check_models(host_lib)
    monkeypatch.setattr(_build, "KERNEL_MODELS", ("single", "double"))
    with pytest.raises(RuntimeError, match="model ids"):
        _build.check_models(host_lib)
