"""Integration ops and QR-Schur helpers of the PyTorch port against the JAX
package, in f64 on random inputs made with numpy: ``mod_pi`` (including
+-pi), the rows-form RK4, rollouts and segment Jacobians, their packed
batch-last counterparts, and ``_qr_gram_factor``, each to 1e-12.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

import jax.numpy as jnp

from cartpole_tpu.models import SINGLE_CARTPOLE as REF_MODEL
from cartpole_tpu.models.params import default_single_params as ref_params
from cartpole_tpu.mpc import problem as ref_problem
from cartpole_tpu.ops import integrate as ref_integrate
from cartpole_tpu.ops import lanes as ref_lanes
from cartpole_tpu_torch.models.base import SINGLE_CARTPOLE
from cartpole_tpu_torch.models.params import default_single_params
from cartpole_tpu_torch.mpc import problem
from cartpole_tpu_torch.ops import integrate, lanes

TOL = dict(rtol=1e-12, atol=1e-12)
ANGLE = (1,)
H = 0.01


def _np(v):
    return np.asarray(v, np.float64)


def _rows(seed, m=32):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1.0, 1.0, (4, m)) * np.array([[0.5], [3.0], [2.0], [6.0]])
    return x


def _fns():
    dp = default_single_params(torch.float64, device="cpu")
    dp_r = ref_params(jnp.float64)
    return (
        lambda xr, u: SINGLE_CARTPOLE.dynamics_core(dp, xr, u),
        lambda xr, u: REF_MODEL.dynamics_core(dp_r, xr, u),
        lambda xr, u: SINGLE_CARTPOLE.dynamics_jac_core(dp, xr, u),
        lambda xr, u: REF_MODEL.dynamics_jac_core(dp_r, xr, u),
    )


def _assert_nested(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_nested(x, y)
        return
    assert isinstance(a, float) == isinstance(b, float)
    np.testing.assert_allclose(_np(a), _np(b), **TOL)


@pytest.mark.parametrize("angles", [
    [math.pi, -math.pi, 0.0, 2 * math.pi, -2 * math.pi, 3 * math.pi],
    list(np.random.RandomState(0).uniform(-20.0, 20.0, 64)),
])
def test_mod_pi_matches_reference(angles):
    a = np.asarray(angles, np.float64)
    out = integrate.mod_pi(torch.as_tensor(a)).numpy()
    np.testing.assert_array_equal(out, _np(ref_integrate.mod_pi(jnp.asarray(a))))
    assert np.all(out > -math.pi) and np.all(out <= math.pi)


def test_mod_pi_half_open_boundary():
    out = integrate.mod_pi(torch.tensor([math.pi, -math.pi],
                                        dtype=torch.float64))
    assert out.tolist() == [math.pi, math.pi]


@pytest.mark.parametrize("dt,internal", [(0.01, 1e-3), (0.0125, 1e-3),
                                          (0.001, 1e-3)])
def test_split_substeps_matches_reference(dt, internal):
    assert integrate.split_substeps(dt, internal) == \
        ref_integrate.split_substeps(dt, internal)


def test_rk4_step_rows_matches_reference():
    f, f_r, _, _ = _fns()
    x = _rows(1)
    u = np.random.RandomState(2).uniform(-30.0, 30.0, 32)
    out = lanes.rk4_step_rows(f, tuple(torch.as_tensor(x)),
                              torch.as_tensor(u), H)
    ref = ref_lanes.rk4_step_rows(f_r, tuple(jnp.asarray(x)),
                                  jnp.asarray(u), H)
    _assert_nested(out, ref)


@pytest.mark.parametrize("stack", [False, True])
def test_rollout_rows_matches_reference(stack):
    f, f_r, _, _ = _fns()
    x = _rows(3)
    us = np.random.RandomState(4).uniform(-30.0, 30.0, (7, 32))
    out = lanes.rollout_rows(f, tuple(torch.as_tensor(x)),
                             torch.as_tensor(us), H, ANGLE,
                             stack_states=stack)
    ref = ref_lanes.rollout_rows(f_r, tuple(jnp.asarray(x)),
                                 jnp.asarray(us), H, ANGLE,
                                 stack_states=stack)
    _assert_nested(out, ref)


def test_rk4_step_with_jac_rows_matches_reference():
    _, _, fj, fj_r = _fns()
    x = _rows(5)
    u = np.random.RandomState(6).uniform(-30.0, 30.0, 32)
    out = lanes.rk4_step_with_jac_rows(fj, tuple(torch.as_tensor(x)),
                                       torch.as_tensor(u), H)
    ref = ref_lanes.rk4_step_with_jac_rows(fj_r, tuple(jnp.asarray(x)),
                                           jnp.asarray(u), H)
    _assert_nested(out, ref)


def test_segment_rollout_with_jac_rows_matches_reference():
    _, _, fj, fj_r = _fns()
    x = _rows(7)
    us = np.random.RandomState(8).uniform(-30.0, 30.0, (5, 32))
    out = lanes.segment_rollout_with_jac_rows(
        fj, tuple(torch.as_tensor(x)), torch.as_tensor(us), H, ANGLE)
    ref = ref_lanes.segment_rollout_with_jac_rows(
        fj_r, tuple(jnp.asarray(x)), jnp.asarray(us), H, ANGLE)
    _assert_nested(out, ref)


@pytest.mark.parametrize("n", [1, 4])
def test_qr_gram_factor_matches_reference(n):
    rng = np.random.RandomState(10 + n)
    cols = [rng.normal(size=(12, 6)) for _ in range(n)]
    b = [rng.normal(size=6) for _ in range(n)]
    out = problem._qr_gram_factor([torch.as_tensor(c) for c in cols])(
        [torch.as_tensor(v) for v in b])
    ref = ref_problem._qr_gram_factor([jnp.asarray(c) for c in cols])(
        [jnp.asarray(v) for v in b])
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)
    # It solves the Gram system without forming it.
    T = np.stack(cols, axis=1)  # (12, n, 6)
    gram = np.einsum("mib,mjb->bij", T, T)
    np.testing.assert_allclose(
        np.einsum("bij,jb->ib", gram, out.numpy()), np.stack(b), atol=1e-9)


def test_problem_statics_match_reference():
    from cartpole_tpu.mpc.config import OptimizationParams as RefParams
    from cartpole_tpu_torch.mpc.config import OptimizationParams

    kw = dict(window_length=10, state_spacing=2)
    spec = problem.MPCProblemSpec(OptimizationParams(**kw), SINGLE_CARTPOLE)
    ref = ref_problem.MPCProblemSpec(RefParams(**kw), REF_MODEL)
    assert spec.terminal_costs == tuple(
        problem.TerminalSpec(*dataclass_values(t)) for t in ref.terminal_costs)
    assert spec.terminal_eqs == tuple(
        problem.TerminalSpec(*dataclass_values(t)) for t in ref.terminal_eqs)
    for name in ("_J_cost", "_J_cost_u", "_A_lin", "_angle_mask",
                 "_pos_mask", "_u_mask"):
        np.testing.assert_array_equal(getattr(spec, name), getattr(ref, name))
    assert (spec.dim, spec.n_res, spec.n_eq) == (ref.dim, ref.n_res, ref.n_eq)


def dataclass_values(t):
    return (t.coord, t.target, t.weight, t.is_angle, t.is_setpoint)


def _packed_fns(per_instance=False):
    """Packed dynamics of both packages, with per-instance (m_1, l_1) when
    asked."""
    import dataclasses

    dp = default_single_params(torch.float64, device="cpu")
    dp_r = ref_params(jnp.float64)
    if per_instance:
        rng = np.random.RandomState(12)
        m1, l1 = rng.uniform(0.08, 0.14, 32), rng.uniform(0.2, 0.3, 32)
        dp = dataclasses.replace(dp, m_1=torch.as_tensor(m1),
                                 l_1=torch.as_tensor(l1))
        dp_r = dataclasses.replace(dp_r, m_1=jnp.asarray(m1),
                                   l_1=jnp.asarray(l1))
    return (lambda x, u: SINGLE_CARTPOLE.dynamics(dp, x, u),
            lambda x, u: REF_MODEL.dynamics(dp_r, x, u))


def test_packed_matrix_ops_match_reference():
    rng = np.random.RandomState(13)
    A, Bm = rng.normal(size=(4, 4, 32)), rng.normal(size=(4, 4, 32))
    v = rng.normal(size=(4, 32))
    t = torch.as_tensor
    np.testing.assert_allclose(lanes.bmat(t(A), t(Bm)).numpy(),
                               _np(ref_lanes.bmat(jnp.asarray(A),
                                                  jnp.asarray(Bm))), **TOL)
    np.testing.assert_allclose(lanes.bmv(t(A), t(v)).numpy(),
                               _np(ref_lanes.bmv(jnp.asarray(A),
                                                 jnp.asarray(v))), **TOL)
    np.testing.assert_array_equal(
        lanes.beye(4, torch.float64).numpy(),
        _np(ref_lanes.beye(4, jnp.float64)))
    x = v * 4.0
    np.testing.assert_array_equal(
        lanes.wrap_angles_lanes(t(x), ANGLE).numpy(),
        _np(ref_lanes.wrap_angles_lanes(jnp.asarray(x), ANGLE)))


@pytest.mark.parametrize("per_instance", [False, True])
def test_rk4_step_lanes_matches_reference(per_instance):
    f, f_r = _packed_fns(per_instance)
    x = _rows(14)
    u = np.random.RandomState(15).uniform(-30.0, 30.0, 32)
    out = lanes.rk4_step_lanes(f, torch.as_tensor(x), torch.as_tensor(u), H)
    ref = ref_lanes.rk4_step_lanes(f_r, jnp.asarray(x), jnp.asarray(u), H)
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


def test_segment_rollout_with_jac_scan_matches_reference():
    _, _, fj, fj_r = _fns()
    x = _rows(16)
    us = np.random.RandomState(17).uniform(-30.0, 30.0, (5, 32))
    out = lanes.segment_rollout_with_jac_scan(
        fj, tuple(torch.as_tensor(x)), torch.as_tensor(us), H, ANGLE)
    ref = ref_lanes.segment_rollout_with_jac_scan(
        fj_r, tuple(jnp.asarray(x)), jnp.asarray(us), H, ANGLE)
    for a, b in zip(out, ref):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), _np(b), **TOL)


def _packed_jac_fns():
    dp = default_single_params(torch.float64, device="cpu")
    dp_r = ref_params(jnp.float64)
    return (lambda x, u: SINGLE_CARTPOLE.dynamics_jac(dp, x, u),
            lambda x, u: REF_MODEL.dynamics_jac(dp_r, x, u))


def test_rk4_step_with_jac_lanes_matches_reference():
    fj, fj_r = _packed_jac_fns()
    x = _rows(18)
    u = np.random.RandomState(19).uniform(-30.0, 30.0, 32)
    out = lanes.rk4_step_with_jac_lanes(fj, torch.as_tensor(x),
                                        torch.as_tensor(u), H)
    ref = ref_lanes.rk4_step_with_jac_lanes(fj_r, jnp.asarray(x),
                                            jnp.asarray(u), H)
    for a, b in zip(out, ref):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), _np(b), **TOL)


def test_segment_rollout_with_jac_lanes_matches_reference():
    fj, fj_r = _packed_jac_fns()
    x = _rows(20)
    us = np.random.RandomState(21).uniform(-30.0, 30.0, (3, 32))
    out = lanes.segment_rollout_with_jac_lanes(
        fj, torch.as_tensor(x), torch.as_tensor(us), H, ANGLE)
    ref = ref_lanes.segment_rollout_with_jac_lanes(
        fj_r, jnp.asarray(x), jnp.asarray(us), H, ANGLE)
    for a, b in zip(out, ref):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), _np(b), **TOL)


@pytest.mark.parametrize("stack", [False, True])
def test_rollout_lanes_matches_reference(stack):
    f, f_r = _packed_fns(False)
    x = _rows(22)
    us = np.random.RandomState(23).uniform(-30.0, 30.0, (4, 32))
    out = lanes.rollout_lanes(f, torch.as_tensor(x), torch.as_tensor(us), H,
                              ANGLE, stack_states=stack)
    ref = ref_lanes.rollout_lanes(f_r, jnp.asarray(x), jnp.asarray(us), H,
                                  ANGLE, stack_states=stack)
    for a, b in zip(out if stack else (out,), ref if stack else (ref,)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), _np(b), **TOL)
