"""The port's per-instance integration ops, packed dynamics Jacobians and MPC
problem closures against the JAX package's, in f64 on the same numpy data.

* ``ops/integrate.py`` (``wrap_angles``, ``rk4_step``,
  ``rk4_step_with_jac``, ``rollout``, ``segment_rollout_with_jac``,
  ``substep_rollout``) and ``model.dynamics_jac`` for the three models:
  1e-12.
* ``MPCProblemSpec.make_problem_fns`` (``linearize``, ``evaluate``,
  ``retract``) at 1e-12 and ``make_condensed_step`` at 1e-10, on random
  iterates of a tiny problem (window 4, spacing 2), with the segment
  Jacobians by AD and by the generated analytic Jacobians, with hard and
  soft terminal rows, equality re-basing, and the double pole.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

import jax
import jax.numpy as jnp

import cartpole_tpu as ct
from cartpole_tpu.ops import integrate as ref_integrate
import cartpole_tpu_torch as pt
from cartpole_tpu_torch.convert import params_from_numpy
from cartpole_tpu_torch.ops import integrate

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")

MODELS = ("single", "double", "triple")
H = 0.01


def _params(name):
    """Both packages' default params of ``name``, f64."""
    ref = ct.get_model(name).default_params()
    d = {k: np.asarray(v, np.float64) for k, v in ref.as_dict().items()}
    ref = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), ref)
    return ref, params_from_numpy(d, device="cpu", model=pt.get_model(name))


def _state(name, seed):
    sd = pt.get_model(name).state_dim
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1.0, 1.0, sd)
    x[1:sd // 2] += math.pi / 2  # near upright, every angle
    return x


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("name", MODELS)
def test_dynamics_jac_matches(name):
    ref_p, p = _params(name)
    rm, m = ct.get_model(name), pt.get_model(name)
    for seed in range(3):
        x, u = _state(name, seed), 7.0 * seed - 5.0
        want = rm.dynamics_jac(ref_p, jnp.asarray(x), u)
        got = m.dynamics_jac(p, torch.as_tensor(x), torch.tensor(u))
        for a, b in zip(got, want):
            assert tuple(a.shape) == tuple(b.shape)
            _close(a.numpy(), b, 1e-12)


@pytest.mark.parametrize("name", MODELS)
def test_integrators_match(name):
    ref_p, p = _params(name)
    rm, m = ct.get_model(name), pt.get_model(name)
    angle = m.angle_indices
    x = _state(name, 4)
    us = np.linspace(-20.0, 30.0, 5)
    f_r = lambda x_, u_: rm.dynamics(ref_p, x_, u_)  # noqa: E731
    f_p = lambda x_, u_: m.dynamics(p, x_, u_)  # noqa: E731
    fj_r = lambda x_, u_: rm.dynamics_jac(ref_p, x_, u_)  # noqa: E731
    fj_p = lambda x_, u_: m.dynamics_jac(p, x_, u_)  # noqa: E731
    xr, xp = jnp.asarray(x), torch.as_tensor(x)
    ur, up = jnp.asarray(us), torch.as_tensor(us)

    _close(integrate.rk4_step(f_p, xp, up[0], H).numpy(),
           ref_integrate.rk4_step(f_r, xr, ur[0], H), 1e-12)
    for a, b in zip(integrate.rk4_step_with_jac(fj_p, xp, up[1], H),
                    ref_integrate.rk4_step_with_jac(fj_r, xr, ur[1], H)):
        _close(a.numpy(), b, 1e-12)
    for a, b in zip(integrate.rollout(f_p, xp, up, H, angle),
                    ref_integrate.rollout(f_r, xr, ur, H, angle)):
        _close(a.numpy(), b, 1e-12)
    for a, b in zip(
            integrate.segment_rollout_with_jac(fj_p, xp, up, H, angle),
            ref_integrate.segment_rollout_with_jac(fj_r, xr, ur, H, angle)):
        _close(a.numpy(), b, 1e-12)
    for dt in (0.01, 0.0125):  # uniform substeps, and a short last one
        _close(integrate.substep_rollout(f_p, xp, up[2], dt,
                                         angle_indices=angle).numpy(),
               ref_integrate.substep_rollout(f_r, xr, ur[2], dt,
                                             angle_indices=angle), 1e-12)
    wide = np.array([7.0, -7.0, math.pi, -math.pi, 0.5, 13.0, 0.1, 2.0])
    wide = wide[:m.state_dim]
    _close(integrate.wrap_angles(torch.as_tensor(wide), angle).numpy(),
           ref_integrate.wrap_angles(jnp.asarray(wide), angle), 0.0)


# ------------------------------------------------------------ the problem
BASE = dict(window_length=4, state_spacing=2)
CASES = {
    # 1 soft terminal cost, 3 hard terminal equalities (the defaults).
    "default_ad": (dict(), "single"),
    "default_analytic": (dict(analytic_jacobians=True), "single"),
    "rebased": (dict(rebase_equalities=True), "single"),
    "all_soft": (dict(th_final_cost_weight=150.0,
                      th_dot_final_cost_weight=10.0,
                      b_x_dot_final_cost_weight=10.0,
                      u_derivative_cost_weight=0.8), "single"),
    "double_all_soft": (dict(window_length=6, th_final_cost_weight=150.0,
                             th_dot_final_cost_weight=10.0,
                             b_x_dot_final_cost_weight=10.0), "double"),
}


def _fns(case, seed):
    kw, name = CASES[case]
    kw = {**BASE, **kw}
    ref_p, p = _params(name)
    mr = ct.make_mpc(ct.OptimizationParams(**kw), ct.get_model(name))
    mp = pt.make_mpc(pt.OptimizationParams(**kw), pt.get_model(name))
    rng = np.random.RandomState(seed)
    x_cur = _state(name, seed + 10)
    sp, u_prev = 0.3, 2.5
    z = np.concatenate([
        np.tile(x_cur, mp.spec.num_states)
        + rng.normal(0.0, 0.1, mp.spec.num_states * mp.spec.state_dim),
        rng.normal(0.0, 5.0, mp.spec.window_length)])
    dz = rng.normal(0.0, 0.5, z.shape)
    args_r = (jnp.asarray(x_cur), jnp.asarray(sp), jnp.asarray(u_prev), ref_p)
    args_p = (torch.as_tensor(x_cur), torch.tensor(sp, dtype=torch.float64),
              torch.tensor(u_prev, dtype=torch.float64), p)
    return (mr.spec, mp.spec, args_r, args_p, z, dz)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_problem_fns_match(case, seed):
    spec_r, spec_p, args_r, args_p, z, dz = _fns(case, seed)
    lin_r, ev_r, re_r = spec_r.make_problem_fns(*args_r)
    lin_p, ev_p, re_p = spec_p.make_problem_fns(*args_p)
    zr, zp = jnp.asarray(z), torch.as_tensor(z)
    for a, b in zip(lin_p(zp), lin_r(zr)):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a.numpy(), b, 1e-12)
    for a, b in zip(ev_p(zp), ev_r(zr)):
        _close(a.numpy(), b, 1e-12)
    for alpha in (1.0, 0.25):
        _close(re_p(zp, torch.as_tensor(20.0 * dz), alpha).numpy(),
               re_r(zr, jnp.asarray(20.0 * dz), alpha), 1e-12)


@pytest.mark.parametrize("lam", [0.0, 1e-3])
@pytest.mark.parametrize("case", list(CASES))
def test_condensed_step_matches(case, lam):
    spec_r, spec_p, args_r, args_p, z, _ = _fns(case, 2)
    want = spec_r.make_condensed_step(*args_r)(
        jnp.asarray(z), jnp.asarray(lam))
    got = spec_p.make_condensed_step(*args_p)(
        torch.as_tensor(z), torch.tensor(lam, dtype=torch.float64))
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a.numpy(), b, 1e-10)
    assert bool(got[4])


def test_condensed_step_rejects_a_zero_u_gram():
    mp = pt.make_mpc(pt.OptimizationParams(
        **BASE, u_cost_weight=0.0, u_derivative_cost_weight=0.0))
    x = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="nonzero u-cost Gram"):
        mp.spec.make_condensed_step(x, 0.0, x[0], pt.default_single_params(
            torch.float64, device="cpu"))
