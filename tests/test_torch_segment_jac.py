"""The segment-Jacobian kernel of the PyTorch port against the JAX package.

``cartpole_tpu_torch/ops/pallas_kernels.py::segment_jac_batch_last_reference``
(the plain version) is held against the reference's plain chain rule
``cartpole_tpu/ops/lanes.py::segment_rollout_with_jac_scan``, the function
whose contract the reference's Pallas kernel
``cartpole_tpu/ops/pallas_kernels.py::segment_jac_batch_last`` implements
(``tests/test_pallas_kernel.py`` holds that kernel against the same chain
rule), in f64 over 3 x 128 columns, sp=5, to atol 1e-12, for the single
model and, over 2 x 128 columns, for the double and triple. The kernel body
(``csrc/segment_jac.cuh``) is compiled with g++ through
``ops/_build.build_host_library`` and held against the plain version in f64
to 1e-12, for every step count its launchers dispatch to, and for the
double and triple at sp = 1, 5 and 16.
The wrapper takes the plain version on CPU tensors, and its input guards
(which a CUDA launch runs first) raise on what the kernel does not take.
"""

import ctypes
import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

import jax.numpy as jnp

import cartpole_tpu as ct
from cartpole_tpu.models import SINGLE_CARTPOLE as REF_MODEL
from cartpole_tpu.models import _double_gen as ref_double_gen
from cartpole_tpu.models import _single_gen as ref_gen
from cartpole_tpu.models import _triple_gen as ref_triple_gen
from cartpole_tpu.ops.lanes import (segment_rollout_with_jac_rows,
                                    segment_rollout_with_jac_scan)
from cartpole_tpu_torch.models.base import SINGLE_CARTPOLE, get_model
from cartpole_tpu_torch.ops import pallas_kernels as pk
from cartpole_tpu_torch.ops._build import build_host_library

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
    lib = ctypes.CDLL(build_host_library(
        str(tmp_path_factory.mktemp("segjac_host")), gxx))
    fn = lib.segment_jac_host_f64
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 2 + [ctypes.c_double] * 3
                   + [ctypes.c_int])
    fn.restype = ctypes.c_int
    return lib


def _host(lib, p, xs, us, angle=ANGLE, model=SINGLE_CARTPOLE):
    p, xs, us = (torch.as_tensor(np.ascontiguousarray(a)) for a in (p, xs, us))
    R, sp, sd = xs.shape[1], us.shape[0], xs.shape[0]
    xe = torch.empty((sd, R), dtype=torch.float64)
    jx = torch.empty((sd, sd, R), dtype=torch.float64)
    ju = torch.empty((sd, sp, R), dtype=torch.float64)
    rc = lib.segment_jac_host_f64(
        pk.KERNEL_MODELS.index(model.name), p.data_ptr(), xs.data_ptr(),
        us.data_ptr(), xe.data_ptr(), jx.data_ptr(), ju.data_ptr(), R, sp, H,
        H * 0.5, H / 6.0, sum(1 << a for a in angle))
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
            0, p.ctypes.data, xs.ctypes.data, us.data_ptr(), out.data_ptr(),
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
    other = dataclasses.replace(SINGLE_CARTPOLE, name="quadruple")
    with pytest.raises(ValueError, match="no compiled dynamics"):
        pk.check_kernel_inputs(p, xs, us, ANGLE, other)


# ------------------------------------------------------- double and triple
REF_GEN = {"double": ref_double_gen, "triple": ref_triple_gen}


def _inputs_model(name, R, sp, seed, per_column=False):
    """Random columns of the double or triple model, numpy f64: positions
    in [-1, 1], angles in [-4, 4], base velocity in [-3, 3], rates in [-8,
    8], the model's default params (scaled per column by U(0.7, 1.3) with
    ``per_column``)."""
    model = get_model(name)
    rng = np.random.RandomState(seed)
    n_q = model.state_dim // 2
    scale = [1.0] + [4.0] * (n_q - 1) + [3.0] + [8.0] * (n_q - 1)
    xs = rng.uniform(-1, 1, (model.state_dim, R)) * np.array(scale)[:, None]
    us = rng.uniform(-10, 10, (sp, R))
    d = ct.get_model(name).default_params().as_dict()
    p = np.array([[float(v)] * R for v in d.values()])
    if per_column:
        p = p * rng.uniform(0.7, 1.3, p.shape)
    return np.ascontiguousarray(p), xs, us


def _plain_model(name, p, xs, us):
    model = get_model(name)
    return pk.segment_jac_batch_last_reference(
        torch.as_tensor(p), torch.as_tensor(xs), torch.as_tensor(us), H,
        model.angle_indices, model)


@pytest.mark.parametrize("name", ["double", "triple"])
def test_plain_matches_reference_chain_rule_multilink(name):
    """The plain version of the double and triple against the reference's
    chain rule over their generated Jacobian cores, default and
    per-column params. The reference runs its rows-form chain rule
    (``segment_rollout_with_jac_rows``, the same arithmetic as the scan
    form) op by op: compiling the scan over these cores takes minutes."""
    blocks = [_inputs_model(name, 128, 5, seed=10),
              _inputs_model(name, 128, 5, seed=11, per_column=True)]
    p, xs, us = (np.concatenate([b[k] for b in blocks], axis=1)
                 for k in range(3))
    R, sd = xs.shape[1], xs.shape[0]
    jac = getattr(REF_GEN[name], f"{name}_dynamics_jac_core")
    p_rows = tuple(jnp.asarray(row) for row in p)
    x_r, jx_r, cols_r = segment_rollout_with_jac_rows(
        lambda xr, u: jac(p_rows, xr, u),
        tuple(jnp.asarray(row) for row in xs), jnp.asarray(us), H,
        ct.get_model(name).angle_indices)

    def arr(v):
        return np.broadcast_to(np.asarray(v, np.float64), (R,))

    ref = (np.stack([arr(v) for v in x_r]),
           np.stack([np.stack([arr(v) for v in row]) for row in jx_r]),
           np.stack([np.stack([arr(col[i]) for col in cols_r])
                     for i in range(sd)]))
    for a, b in zip(_plain_model(name, p, xs, us), ref, strict=True):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("sp", [1, 5, pk.SPMAX])
@pytest.mark.parametrize("name", ["double", "triple"])
def test_host_build_matches_plain_version_multilink(host_lib, name, sp):
    """The kernel body's double and triple instantiations, built with g++,
    against the plain version."""
    model = get_model(name)
    p, xs, us = _inputs_model(name, 24, sp, seed=sp, per_column=True)
    got = _host(host_lib, p, xs, us, model.angle_indices, model)
    for a, b in zip(got, _plain_model(name, p, xs, us), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("name", ["double", "triple"])
def test_kernel_input_guards_check_the_model(name):
    """The guards take the model's parameter and state counts."""
    model = get_model(name)
    p, xs, us = (torch.as_tensor(a) for a in _inputs_model(name, 16, 5, 0))
    mask = sum(1 << a for a in model.angle_indices)
    assert pk.check_kernel_inputs(p, xs, us, model.angle_indices,
                                  model) == mask
    with pytest.raises(ValueError, match="expects params"):
        pk.check_kernel_inputs(p[:-1], xs, us, model.angle_indices, model)
    with pytest.raises(ValueError, match="expects params"):
        pk.check_kernel_inputs(p, xs[:-2], us, model.angle_indices, model)
