"""The port's per-instance solver (``ops/solver.py::solve_nls``) against the
JAX package's, on the generic problems of ``tests/test_solver.py``.

Each problem is written once over an array namespace and built in both
frameworks from the same numpy data (seeded): the JAX package's Jacobians
come from ``jax.jacfwd``, the port's from ``torch.func.jacfwd``. For the
``lu`` and ``schur`` KKT paths, in f64: equal termination codes and
iteration counts, z within 1e-10. The port runs without the reference's
multiple-of-16 KKT padding (a TPU workaround), on an awkward size too. A
singular KKT system and a non-finite Jacobian end the solve with the
reference's codes (QP_INDEFINITE for the non-finite step), where
``torch.linalg`` would raise; vmapped solves equal the
instance-by-instance ones, with no batching rule missing.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

import jax
import jax.numpy as jnp

from cartpole_tpu.ops.solver import NLSConfig as RefConfig
from cartpole_tpu.ops.solver import NLSProblem as RefProblem
from cartpole_tpu.ops.solver import solve_nls as ref_solve
import cartpole_tpu_torch as pt
from cartpole_tpu_torch.ops import solver

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")

RNG = np.random.default_rng(0)
LS_A, LS_B = RNG.normal(size=(6, 3)), RNG.normal(size=(6,))
BIG_A, BIG_B = RNG.normal(size=(90, 83)), RNG.normal(size=(90,))
PLANE = np.array([3.0, -1.0, 0.5])


def _stack(xp, items):
    return xp.stack(items) if xp is jnp else torch.stack(items)


def _problems(xp):
    """name -> (residual, constraint or None, retract clip or None, z0,
    config kwargs), over the array namespace ``xp`` (jnp or torch)."""
    arr = ((lambda a: jnp.asarray(a)) if xp is jnp
           else (lambda a: torch.as_tensor(a)))
    A, b, Ab, bb, a = (arr(v) for v in (LS_A, LS_B, BIG_A, BIG_B, PLANE))
    return {
        "linear_least_squares": (lambda z: A @ z - b, None, None,
                                 np.zeros(3), dict(max_iterations=5)),
        "awkward_dim_83": (lambda z: Ab @ z - bb, None, None, np.zeros(83),
                           dict(max_iterations=5)),
        "rosenbrock": (
            lambda z: _stack(xp, [1.0 - z[0], 10.0 * (z[1] - z[0] ** 2)]),
            None, None, np.array([-1.2, 1.0]),
            dict(max_iterations=50, relative_exit_tol=1e-14)),
        "projection_onto_plane": (
            lambda z: z - a, lambda z: _stack(xp, [z.sum() - 1.0]), None,
            np.zeros(3), dict(max_iterations=10)),
        "nonlinear_constraint": (
            lambda z: z, lambda z: _stack(xp, [z[0] ** 2 + z[1] ** 2 - 4.0]),
            None, np.array([3.0, 1.0]),
            dict(max_iterations=30, relative_exit_tol=1e-12)),
        "retraction_clamps": (lambda z: z - 10.0, None, 2.0, np.zeros(2),
                              dict(max_iterations=10)),
        "singular_kkt": (lambda z: 0.0 * z, lambda z: _stack(xp, [z[0] - 1.0]),
                         None, np.zeros(2), dict(max_iterations=3)),
        "non_finite_jacobian": (
            lambda z: z * (z[0] * 0.0 + np.inf), lambda z: _stack(
                xp, [z.sum() - 1.0]), None, np.ones(2),
            dict(max_iterations=3)),
    }


def _ref_problem(res, con, clip):
    def linearize(z):
        r, J = res(z), jax.jacfwd(res)(z)
        c, A = (None, None) if con is None else (con(z), jax.jacfwd(con)(z))
        return r, J, c, A

    def retract(z, dz, alpha):
        z2 = z + alpha * dz
        return z2 if clip is None else jnp.clip(z2, -clip, clip)

    return RefProblem(
        linearize=linearize,
        evaluate=lambda z: (res(z), None if con is None else con(z)),
        retract=retract)


def _port_problem(res, con, clip):
    def linearize(z):
        r, J = res(z), torch.func.jacfwd(res)(z)
        c, A = ((None, None) if con is None
                else (con(z), torch.func.jacfwd(con)(z)))
        return r, J, c, A

    def retract(z, dz, alpha):
        z2 = z + alpha * dz
        return z2 if clip is None else torch.clamp(z2, -clip, clip)

    return pt.NLSProblem(
        linearize=linearize,
        evaluate=lambda z: (res(z), None if con is None else con(z)),
        retract=retract)


NAMES = list(_problems(np))


@pytest.fixture(scope="module")
def solves():
    """Both packages' solves of every problem by both KKT methods."""
    ref, port = _problems(jnp), _problems(torch)
    out = {}
    for name in NAMES:
        for method in ("lu", "schur"):
            res, con, clip, z0, kw = ref[name]
            zr, outr = ref_solve(_ref_problem(res, con, clip),
                                 jnp.asarray(z0), RefConfig(
                                     kkt_method=method, **kw))
            res, con, clip, z0, kw = port[name]
            zp, outp = pt.solve_nls(_port_problem(res, con, clip),
                                    torch.as_tensor(z0), pt.NLSConfig(
                                        kkt_method=method, **kw))
            out[name, method] = (zr, outr), (zp, outp)
    return out


@pytest.mark.parametrize("method", ["lu", "schur"])
@pytest.mark.parametrize("name", NAMES)
def test_solve_matches_reference(solves, name, method):
    (zr, outr), (zp, outp) = solves[name, method]
    assert int(outp.termination_state) == int(outr.termination_state)
    assert int(outp.n_iterations) == int(outr.n_iterations)
    np.testing.assert_allclose(zp.numpy(), np.asarray(zr), atol=1e-10,
                               rtol=0)
    for field in ("cost", "constraint_violation", "lambda_final"):
        np.testing.assert_allclose(getattr(outp, field).numpy(),
                                   np.asarray(getattr(outr, field)),
                                   atol=1e-10, rtol=1e-10)
    _assert_step_sizes_match(outp, outr)


def _assert_step_sizes_match(outp, outr):
    """The accepted step sizes agree within 1e-10, except on an iteration
    that starts at the solve's final cost to rounding (its ``iter_cost``
    within ``8 eps |cost|`` of it): there both sides of the Armijo test are
    the optimum's merit to a few ulps, and which side wins follows the BLAS
    reduction order, so both packages need only agree on whether a step was
    taken. ``scripts/probe_awkward_dim_83.py`` measured it on the 83-unknown
    problem's second iteration: the full step's merit lies 12.1 (JAX) and
    8.1 (the port, 1 and 6 threads) ulps of ``phi0`` below the Armijo bound
    (``phi0 + c1 dphi + slack``, ``c1 dphi`` ~1e-31) and, with 8 threads,
    4.8 ulps above it, so there the port takes the half step where the
    reference takes the whole one."""
    alpha_p = outp.iter_step_size.numpy()
    alpha_r = np.asarray(outr.iter_step_size)
    cost = float(outr.cost)
    with np.errstate(invalid="ignore"):  # a failed solve's costs are NaN
        noise = np.abs(np.asarray(outr.iter_cost) - cost) <= (
            8 * np.finfo(np.float64).eps * abs(cost))
    np.testing.assert_array_equal(alpha_p[noise] > 0, alpha_r[noise] > 0)
    np.testing.assert_allclose(alpha_p[~noise], alpha_r[~noise], atol=1e-10,
                               rtol=1e-10)


@pytest.mark.parametrize("name,method,code", [
    ("singular_kkt", "lu", 2), ("non_finite_jacobian", "lu", 4),
    ("non_finite_jacobian", "schur", 4)])
def test_failed_factorization_ends_the_solve(solves, name, method, code):
    """A failed factorization ends the solve in its first iteration with
    the reference's code: QP_INDEFINITE (4) where the step is non-finite,
    and on the singular KKT system SATISFIED_FIRST_ORDER_TOL (2), as the
    zero pivot leaves the multiplier, and so the gradient of the
    Lagrangian, finite and 0. (The schur path's augmented Hessian stays PD
    on that system.)"""
    (zr, outr), (zp, outp) = solves[name, method]
    assert int(outp.termination_state) == code
    assert int(outr.termination_state) == code
    assert int(outp.n_iterations) == int(outr.n_iterations) == 1


def test_factorization_helpers_give_nan_not_raise():
    """``cholesky`` of an indefinite matrix is all NaN, and ``solve`` with
    a singular one is not finite, where ``torch.linalg.cholesky`` /
    ``solve`` raise."""
    indefinite = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    with pytest.raises(RuntimeError):
        torch.linalg.cholesky(indefinite)
    assert torch.isnan(solver.cholesky(indefinite)).all()
    singular = torch.tensor([[1.0, 2.0], [2.0, 4.0]], dtype=torch.float64)
    with pytest.raises(RuntimeError):
        torch.linalg.solve(singular, torch.ones(2, dtype=torch.float64))
    assert not torch.isfinite(solver.solve(singular, torch.ones(
        2, dtype=torch.float64))).any()
    spd = torch.tensor([[4.0, 1.0], [1.0, 3.0]], dtype=torch.float64)
    np.testing.assert_allclose(solver.cholesky(spd).numpy(),
                               np.linalg.cholesky(spd.numpy()))
    B = torch.tensor([[1.0, 0.5], [2.0, -1.0]], dtype=torch.float64)
    np.testing.assert_allclose(
        solver.cho_solve(solver.cholesky(spd), B).numpy(),
        np.linalg.solve(spd.numpy(), B.numpy()), atol=1e-14)


def test_vmap_matches_instance_by_instance():
    """``torch.func.vmap(solve_nls)`` over 8 targets equals 8 single
    solves (the reference's ``test_vmap_matches_sequential``)."""
    targets = torch.as_tensor(np.random.default_rng(42).normal(size=(8, 3)))

    def solve_one(a):
        res = lambda z: z * z - a  # noqa: E731
        con = lambda z: torch.stack([z.sum() - 1.0])  # noqa: E731
        return pt.solve_nls(_port_problem(res, con, None),
                            torch.full((3,), 0.7, dtype=torch.float64),
                            pt.NLSConfig(max_iterations=25, kkt_method="schur"))

    zb, outb = torch.func.vmap(solve_one)(targets)
    for i in range(8):
        zi, outi = solve_one(targets[i])
        np.testing.assert_allclose(zb[i].numpy(), zi.numpy(), atol=1e-12)
        assert int(outb.termination_state[i]) == int(outi.termination_state)
        assert int(outb.n_iterations[i]) == int(outi.n_iterations)


def test_traces_freeze_and_names():
    """Frozen iterations record NaN cost and a 0 step; the codes have the
    reference's names."""
    res, con, _, z0, _ = _problems(torch)["projection_onto_plane"]
    _, out = pt.solve_nls(_port_problem(res, con, None), torch.as_tensor(z0),
                          pt.NLSConfig(max_iterations=9))
    n = int(out.n_iterations)
    assert out.iter_cost.shape == (9,) and 0 < n < 9
    assert torch.isnan(out.iter_cost[n:]).all()
    assert (out.iter_step_size[n:] == 0).all()
    assert [pt.termination_state_name(c) for c in range(5)] == [
        "MAX_ITERATIONS", "SATISFIED_RELATIVE_TOL",
        "SATISFIED_FIRST_ORDER_TOL", "MAX_LAMBDA", "QP_INDEFINITE"]
    with pytest.raises(ValueError, match="unknown kkt_method"):
        pt.solve_nls(_port_problem(res, con, None), torch.as_tensor(z0),
                     pt.NLSConfig(kkt_method="qr"))
    with pytest.raises(ValueError, match="condensed_step"):
        pt.solve_nls(_port_problem(res, con, None), torch.as_tensor(z0),
                     pt.NLSConfig(kkt_method="condensed"))
