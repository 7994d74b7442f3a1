"""The segment-Jacobian kernel of the PyTorch port against the JAX package.

``cartpole_tpu_torch/ops/pallas_kernels.py::segment_jac_batch_last_reference``
(the plain version) is held against the reference's plain chain rule
``cartpole_tpu/ops/lanes.py::segment_rollout_with_jac_scan``, the function
whose contract the reference's Pallas kernel
``cartpole_tpu/ops/pallas_kernels.py::segment_jac_batch_last`` implements
(``tests/test_pallas_kernel.py`` holds that kernel against the same chain
rule), in f64 over 3 x 128 columns, sp=5, to atol 1e-12. The kernel body
(``csrc/segment_jac.cuh``) is compiled with g++ through
``csrc/host_check.cc`` and held against the plain version in f64 to 1e-12,
for every step count its launchers dispatch to.
The wrapper takes the plain version on CPU tensors, and its input guards
(which a CUDA launch runs first) raise on what the kernel does not take.
"""

import ctypes
import dataclasses
import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

import jax.numpy as jnp

from cartpole_tpu.models import SINGLE_CARTPOLE as REF_MODEL
from cartpole_tpu.models import _single_gen as ref_gen
from cartpole_tpu.ops.lanes import segment_rollout_with_jac_scan
from cartpole_tpu_torch.models.base import SINGLE_CARTPOLE
from cartpole_tpu_torch.ops import pallas_kernels as pk

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cartpole_tpu_torch", "csrc")
PARAMS = (1.0, 0.1, 0.25, 9.81, 0.03, 0.1, 0.13, 0.8, 100.0)
H = 0.01
ANGLE = (1,)


def _inputs(R=256, sp=5, seed=0, per_column=False):
    """(params_cols, xs_cols, us_cols) as numpy f64, made from a seed."""
    rng = np.random.RandomState(seed)
    xs = rng.uniform(-1, 1, (4, R)) * np.array([[1.0], [4.0], [3.0], [8.0]])
    us = rng.uniform(-10, 10, (sp, R))
    p = np.broadcast_to(np.asarray(PARAMS)[:, None], (9, R))
    if per_column:
        p = p * rng.uniform(0.7, 1.3, (9, R))
    return np.ascontiguousarray(p), xs, us


def _plain(p, xs, us, angle=ANGLE):
    return pk.segment_jac_batch_last_reference(
        torch.as_tensor(p), torch.as_tensor(xs), torch.as_tensor(us), H,
        angle)


@pytest.fixture(scope="module")
def against_reference():
    """The reference chain rule over three column blocks: random states
    with the default params, random states with per-column params, and the
    hanging rest state. Returns ``{block: (port outputs, reference
    outputs)}``."""
    blocks = {"default_params": _inputs(R=128, seed=0),
              "per_column_params": _inputs(R=128, seed=1, per_column=True)}
    rest = np.zeros((4, 128))
    rest[1] = -np.pi / 2
    blocks["rest_state"] = (blocks["default_params"][0], rest,
                            np.zeros((5, 128)))
    p, xs, us = (np.concatenate([b[k] for b in blocks.values()], axis=1)
                 for k in range(3))
    p_rows = tuple(jnp.asarray(row) for row in p)
    ref = segment_rollout_with_jac_scan(
        lambda xr, u: ref_gen.single_dynamics_jac_core(p_rows, xr, u),
        tuple(jnp.asarray(row) for row in xs), jnp.asarray(us), H,
        REF_MODEL.angle_indices)
    out = _plain(p, xs, us)
    return {name: tuple((a[..., i * 128:(i + 1) * 128],
                         np.asarray(b)[..., i * 128:(i + 1) * 128])
                        for a, b in zip(out, ref))
            for i, name in enumerate(blocks)}


@pytest.mark.parametrize("block", ["default_params", "per_column_params"])
def test_plain_matches_reference_kernel(against_reference, block):
    for a, b in against_reference[block]:
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-12)


def test_rest_state_finite(against_reference):
    """The where-guarded drag Jacobians stay finite at |v| = 0."""
    for a, b in against_reference["rest_state"]:
        assert bool(torch.all(torch.isfinite(a)))
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("segjac_host") / "libkernels_host.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(out),
         os.path.join(CSRC, "host_check.cc")],
        check=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    fn = lib.segment_jac_host_f64
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                   + [ctypes.c_double] * 3 + [ctypes.c_int])
    fn.restype = ctypes.c_int
    return lib


def _host(lib, p, xs, us, angle=ANGLE):
    p, xs, us = (torch.as_tensor(np.ascontiguousarray(a)) for a in (p, xs, us))
    R, sp = xs.shape[1], us.shape[0]
    xe = torch.empty((4, R), dtype=torch.float64)
    jx = torch.empty((4, 4, R), dtype=torch.float64)
    ju = torch.empty((4, sp, R), dtype=torch.float64)
    rc = lib.segment_jac_host_f64(
        p.data_ptr(), xs.data_ptr(), us.data_ptr(), xe.data_ptr(),
        jx.data_ptr(), ju.data_ptr(), R, sp, H, H * 0.5, H / 6.0,
        sum(1 << a for a in angle))
    assert rc == 0
    return xe, jx, ju


HOST_CASES = {
    "bench_sp5": dict(sp=5),
    "per_column_params": dict(sp=5, per_column=True),
    "one_step": dict(sp=1),
    "sp_max": dict(sp=pk.SPMAX),
    "no_angle_wrap": dict(sp=5, angle=()),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_build_matches_plain_version(host_lib, case):
    kw = dict(HOST_CASES[case])
    angle = kw.pop("angle", ANGLE)
    p, xs, us = _inputs(R=96, seed=3, **kw)
    got = _host(host_lib, p, xs, us, angle)
    want = _plain(p, xs, us, angle)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("sp", range(1, pk.SPMAX + 1))
def test_host_build_every_step_count(host_lib, sp):
    """Each instantiation of the body the step-count dispatch reaches."""
    p, xs, us = _inputs(R=8, sp=sp, seed=sp)
    for a, b in zip(_host(host_lib, p, xs, us), _plain(p, xs, us)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_host_build_refuses_step_counts_out_of_range(host_lib):
    p, xs, _ = _inputs(R=8)
    out = torch.empty(4 * 4 * (pk.SPMAX + 1) * 8, dtype=torch.float64)
    for sp in (0, pk.SPMAX + 1):
        us = torch.zeros((max(sp, 1), 8), dtype=torch.float64)
        assert host_lib.segment_jac_host_f64(
            p.ctypes.data, xs.ctypes.data, us.data_ptr(), out.data_ptr(),
            out.data_ptr(), out.data_ptr(), 8, sp, H, H * 0.5, H / 6.0,
            2) == 1


def test_cpu_tensors_take_the_plain_version():
    p, xs, us = (torch.as_tensor(a) for a in _inputs(R=64))
    before = pk.segment_jac_batch_last.launches
    out = pk.segment_jac_batch_last(p, xs, us, H, ANGLE)
    assert pk.segment_jac_batch_last.launches == before
    for a, b in zip(out, pk.segment_jac_batch_last_reference(p, xs, us, H,
                                                              ANGLE)):
        assert torch.equal(a, b)


def test_kernel_input_guards_raise():
    """What a CUDA launch checks first; it has no fallback."""
    p, xs, us = (torch.as_tensor(a) for a in _inputs(R=64))
    assert pk.check_kernel_inputs(p, xs, us, ANGLE) == 2
    with pytest.raises(TypeError, match="f32 or f64"):
        pk.check_kernel_inputs(p.half(), xs.half(), us.half(), ANGLE)
    with pytest.raises(TypeError, match="one dtype"):
        pk.check_kernel_inputs(p.float(), xs, us, ANGLE)
    with pytest.raises(ValueError, match="expects params"):
        pk.check_kernel_inputs(p[:8], xs, us, ANGLE)
    with pytest.raises(ValueError, match="sp <="):
        big = torch.zeros((pk.SPMAX + 1, 64), dtype=torch.float64)
        pk.check_kernel_inputs(p, xs, big, ANGLE)
    with pytest.raises(ValueError, match="contiguous"):
        pk.check_kernel_inputs(p, xs.T.contiguous().T, us, ANGLE)
    with pytest.raises(ValueError, match="out of range"):
        pk.check_kernel_inputs(p, xs, us, (4,))
    other = dataclasses.replace(SINGLE_CARTPOLE, name="double")
    with pytest.raises(ValueError, match="no compiled dynamics"):
        pk.check_kernel_inputs(p, xs, us, ANGLE, other)
