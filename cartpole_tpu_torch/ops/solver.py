"""The constrained nonlinear least-squares solver (counterpart of
``cartpole_tpu/ops/solver.py``): termination codes, the static solver
configuration, the diagnostics tuple, and :func:`solve_nls`, the
per-instance damped Gauss-Newton solve with its ``lu``, ``schur`` and
``condensed`` KKT paths.

:func:`solve_nls` solves one instance: ``z`` is ``(dim,)``. It batches
under ``torch.func.vmap`` as the reference's does under ``jax.vmap``. The
iteration is a fixed-trip Python loop with per-instance freezing, the line
search evaluates all its trials at once (``vmap`` over the step sizes), and
nothing in it reads a value back to the host, so a tick on the card never
waits for the device. A failed factorization gives NaN, not an exception,
as the reference's ``jnp.linalg`` does: a Cholesky factor is all NaN where
``torch.linalg.cholesky_ex`` reports a non-PD matrix, and an LU solve
(``solve_ex``, unchecked) carries the inf and NaN of a zero pivot; the
non-finite step then ends the solve as QP_INDEFINITE.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch.func import vmap

__all__ = ["NLSTerminationState", "NLSConfig", "NLSProblem", "NLSOutputs",
           "solve_nls", "termination_state_name", "full_f32_matmul"]


class NLSTerminationState:
    """Integer termination codes (analog of
    ``mini_opt::NLSTerminationState``)."""

    MAX_ITERATIONS = 0
    SATISFIED_RELATIVE_TOL = 1
    SATISFIED_FIRST_ORDER_TOL = 2
    MAX_LAMBDA = 3
    QP_INDEFINITE = 4

    _NAMES = {
        0: "MAX_ITERATIONS",
        1: "SATISFIED_RELATIVE_TOL",
        2: "SATISFIED_FIRST_ORDER_TOL",
        3: "MAX_LAMBDA",
        4: "QP_INDEFINITE",
    }


def termination_state_name(code: int) -> str:
    return NLSTerminationState._NAMES.get(int(code), f"UNKNOWN({code})")


@dataclasses.dataclass(frozen=True)
class NLSConfig:
    """Static solver configuration."""

    max_iterations: int = 8
    max_line_search_iterations: int = 5
    relative_exit_tol: float = 1.0e-5
    absolute_first_derivative_tol: float = 1.0e-6
    equality_penalty_initial: float = 1.0
    #: Growth factor applied to the merit penalty when multipliers grow.
    penalty_multiplier_margin: float = 2.0
    lambda_initial: float = 0.0
    lambda_increase: float = 10.0
    lambda_decrease: float = 0.5
    lambda_failure_floor: float = 1.0e-4
    lambda_max: float = 1.0e6
    armijo_c1: float = 1.0e-4
    #: Armijo slack in ulps of the merit value: accept steps whose merit is
    #: within ``merit_slack_ulps * eps(dtype) * |phi0|`` of the Armijo
    #: bound. Near a minimizer the true per-step improvement drops below
    #: f32 rounding noise; a strict comparison then rejects genuine steps
    #: and ratchets lambda to spurious MAX_LAMBDA.
    merit_slack_ulps: float = 4.0
    #: "lu" factors the full symmetric-indefinite KKT system (the C++
    #: oracle's path); "schur" eliminates through the equilibrated
    #: augmented Gauss-Newton Hessian with two Cholesky factorizations;
    #: "condensed" takes the problem's own structure-exploiting step.
    kkt_method: str = "lu"


#: Tiny negative regularization of the KKT constraint block.
KKT_REG = 1.0e-10
#: Primal regularization floor of the "schur" path's augmented Hessian (a
#: floor of 100 ulp of the dtype also applies).
SCHUR_PRIMAL_REG = 1.0e-9
#: Iterative-refinement steps of the "schur" KKT solve (factors reused).
SCHUR_REFINE = 1


@dataclasses.dataclass(frozen=True)
class NLSProblem:
    """A constrained NLS problem as closures over the decision vector ``z``
    ``(dim,)`` (the reference's ``NLSProblem``):

    * ``linearize(z) -> (r, J, c, A)``: residuals ``(n_res,)``, their
      Jacobian ``(n_res, dim)``, equality constraints ``(n_eq,)`` and their
      Jacobian ``(n_eq, dim)``; ``c`` and ``A`` may be ``None``;
    * ``evaluate(z) -> (r, c)``;
    * ``retract(z, dz, alpha) -> z_new`` (wraps angles, clamps);
    * ``condensed_step(z, lam) -> (dz, nu_inf, first_order, jr_dz, ok, r,
      c)``, optional: the structure-exploiting step of
      ``kkt_method="condensed"``.
    """

    linearize: Callable[[Any], Any]
    evaluate: Callable[[Any], Any]
    retract: Callable[[Any, Any, Any], Any]
    condensed_step: Any = None


class NLSOutputs(NamedTuple):
    """Solver diagnostics (the ``NLSSolverOutputs`` analog). One instance's
    are scalars and ``(max_iterations,)`` traces; a batch puts its axis
    first: ``(B,)`` and ``(B, max_iterations)``."""

    termination_state: Any  #: int32 code, see NLSTerminationState.
    n_iterations: Any  #: iterations actually applied (int32).
    cost: Any  #: final 0.5*||r||^2.
    constraint_violation: Any  #: final ||c||_inf.
    first_order_norm: Any  #: final ||J^T r + A^T nu||_inf.
    lambda_final: Any  #: final LM damping.
    #: Per-iteration traces, one entry per iteration:
    iter_cost: Any
    iter_violation: Any
    iter_lambda: Any
    iter_step_size: Any  #: accepted line-search alpha (0 if rejected).
    iter_first_order: Any


@contextlib.contextmanager
def full_f32_matmul():
    """Run f32 matmuls at full f32 precision (no TF32, no bf16 passes) for
    the duration, whatever the caller's global setting, and restore that
    setting on exit, as the reference pins HIGHEST precision
    (ops/solver.py:200, mpc/lanes.py:552, ops/fused.py:209-211). Uses the
    per-backend ``fp32_precision`` settings where torch has them (mixing
    them with the global getter raises there), else the global one."""
    backends = [b for b in (torch.backends.cuda.matmul,
                            torch.backends.mkldnn.matmul)
                if hasattr(b, "fp32_precision")]
    if backends:
        saved = [b.fp32_precision for b in backends]
        for b in backends:
            b.fp32_precision = "ieee"
    else:
        saved = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if backends:
            for b, v in zip(backends, saved):
                b.fp32_precision = v
        else:
            torch.set_float32_matmul_precision(saved)


def cholesky(A):
    """Lower Cholesky factor of ``A``; all NaN where ``A`` is not PD, as
    ``jnp.linalg.cholesky`` gives it (``info`` stays on the device)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.nan)


def solve(A, b):
    """``A^{-1} b`` by LU without the error check: a zero pivot gives the
    inf and NaN of its division, as ``jnp.linalg.solve`` does."""
    return torch.linalg.solve_ex(A, b)[0]


def cho_solve(L, B):
    """``(L L^T)^{-1} B`` for a lower Cholesky factor ``L`` and ``B`` ``(n,
    k)``: two triangular solves, as ``jax.scipy.linalg.cho_solve`` does
    them (``torch.cholesky_solve`` cannot be captured in a CUDA graph)."""
    y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def take(t, i):
    """``t[i]`` for a 0-d index tensor ``i``, on the device: indexing with
    a tensor scalar reads it back to the host."""
    return t.index_select(0, i.reshape(1))[0]


def _merit(cost, c_l1, mu):
    return cost + mu * c_l1


def solve_nls(problem: NLSProblem, z0, config: NLSConfig):
    """Solve one constrained NLS instance from ``z0`` ``(dim,)``. Returns
    ``(z_final, NLSOutputs)``. Batch it with ``torch.func.vmap``.

    f32 matmuls run at full f32 precision throughout
    (:func:`full_f32_matmul`): the KKT factorizations lose definiteness
    under TF32, as they did under the TPU's bf16 passes."""
    with full_f32_matmul():
        return _solve_nls_impl(problem, z0, config)


def _kkt_solve_lu(J, r, A, c, lam):
    """Full symmetric-indefinite KKT factorization (the oracle's path)."""
    dim, n_eq = J.shape[-1], A.shape[-2]
    g = J.T @ r
    H = J.T @ J + lam * torch.eye(dim, dtype=J.dtype, device=J.device)
    reg = -KKT_REG * torch.eye(n_eq, dtype=J.dtype, device=J.device)
    kkt = torch.cat([torch.cat([H, A.T], dim=1), torch.cat([A, reg], dim=1)])
    sol = solve(kkt, torch.cat([-g, -c]))
    return sol[:dim], sol[dim:]


def _kkt_solve_schur(J, r, A, c, lam):
    """Augmented-Lagrangian Schur elimination with two Cholesky solves.

    ``H = J^T J`` is singular (shooting states enter no cost), so the
    exact-equivalent augmented system is solved: ``gamma A^T A`` added to
    ``H`` (and ``gamma A^T c`` to ``g``) leaves the KKT solution unchanged
    and makes the Hessian PD, every variable and row Jacobi-equilibrated
    first so ``gamma = 1`` is the right scale in any dtype."""
    dtype, device = J.dtype, J.device
    n_eq = A.shape[-2]
    g = J.T @ r
    H = J.T @ J

    # Variable equilibration: s ~ 1/sqrt(column magnitude).
    a_col = torch.sum(A * A, dim=0)
    s = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(H) + a_col, 1e-8))
    Hs = (H * s[None, :]) * s[:, None]
    As = A * s[None, :]
    gs = g * s
    # Constraint-row equilibration.
    rrow = 1.0 / torch.sqrt(torch.clamp_min(torch.sum(As * As, dim=1), 1e-8))
    As = As * rrow[:, None]
    cs = c * rrow

    rho = max(SCHUR_PRIMAL_REG, 100.0 * torch.finfo(dtype).eps)
    # gamma = 1 in the equilibrated metric; the LM damping acts in the
    # original variable metric (lam I -> lam s^2).
    H_aug = Hs + As.T @ As + torch.diag_embed(lam * s * s + rho)
    g_aug = gs + As.T @ cs

    L = cholesky(H_aug)
    sol = cho_solve(L, torch.cat([As.T, g_aug[:, None]], dim=1))
    HiAt = sol[:, :n_eq]
    S = As @ HiAt + KKT_REG * torch.eye(n_eq, dtype=dtype,
                                               device=device)
    Ls = cholesky(S)

    def solve_pair(b_d, b_c):
        """Solve H_aug x + As^T y = b_d ; As x = b_c (factors reused)."""
        Hib = cho_solve(L, b_d[:, None])[:, 0]
        y = cho_solve(Ls, (As @ Hib - b_c)[:, None])[:, 0]
        return Hib - HiAt @ y, y

    d_hat, nu_s = solve_pair(-g_aug, -cs)
    # Iterative refinement recovers the digits an f32 factorization loses.
    for _ in range(SCHUR_REFINE):
        res_d = -g_aug - (H_aug @ d_hat + As.T @ nu_s)
        res_c = -cs - As @ d_hat
        e_x, e_y = solve_pair(res_d, res_c)
        d_hat = d_hat + e_x
        nu_s = nu_s + e_y
    return d_hat * s, nu_s * rrow


def _solve_nls_impl(problem: NLSProblem, z0, config: NLSConfig):
    if config.kkt_method not in ("lu", "schur", "condensed"):
        raise ValueError(
            f"unknown kkt_method {config.kkt_method!r}; "
            "expected 'lu', 'schur', or 'condensed'")
    use_condensed = config.kkt_method == "condensed"
    if use_condensed and problem.condensed_step is None:
        raise ValueError(
            "kkt_method='condensed' requires the problem to provide a "
            "condensed_step (the MPC layer builds one; generic NLSProblems "
            "should use 'lu' or 'schur')")
    dtype, device = z0.dtype, z0.device
    dim = z0.shape[-1]
    eps = torch.finfo(dtype).eps

    def scalar(v):
        return torch.full((), v, dtype=dtype, device=device)

    def has_eq(c):
        return c is not None and c.shape[-1] > 0

    def c_l1(c):
        return torch.sum(torch.abs(c)) if has_eq(c) else scalar(0.0)

    def c_inf(c):
        return torch.amax(torch.abs(c)) if has_eq(c) else scalar(0.0)

    def kkt_solve(J, r, A, c, lam):
        """Damped Gauss-Newton KKT step: ``(dz, nu, ok)``."""
        if has_eq(c):
            kkt = (_kkt_solve_schur if config.kkt_method == "schur"
                   else _kkt_solve_lu)
            dz, nu = kkt(J, r, A, c, lam)
        else:
            H = J.T @ J + lam * torch.eye(dim, dtype=dtype, device=device)
            dz = solve(H, -(J.T @ r))
            nu = z0.new_zeros((0,))
        ok = torch.all(torch.isfinite(dz)) & torch.all(torch.isfinite(nu))
        return dz, nu, ok

    ls_alphas = 0.5 ** torch.arange(config.max_line_search_iterations,
                                    dtype=dtype, device=device)

    def iteration(z, lam, mu, merit_prev, done, term, fo_carry):
        if use_condensed:
            dz, nu_inf, first_order, jr_dz, qp_ok, r, c = (
                problem.condensed_step(z, lam))
        else:
            r, J, c, A = problem.linearize(z)
            dz, nu, qp_ok = kkt_solve(J, r, A, c, lam)
            jr = J.T @ r
            grad_lag = jr + A.T @ nu if has_eq(c) else jr
            first_order = torch.amax(torch.abs(grad_lag))
            nu_inf = torch.amax(torch.abs(nu)) if has_eq(c) else scalar(0.0)
            jr_dz = torch.dot(jr, dz)

        cost = 0.5 * torch.dot(r, r)
        viol1 = c_l1(c)
        dz = torch.where(qp_ok, dz, torch.zeros_like(dz))

        # Exact-penalty merit: ramp mu with the multiplier estimates so the
        # GN direction stays a descent direction for the merit.
        mu_new = torch.maximum(mu, config.penalty_multiplier_margin * nu_inf)
        phi0 = _merit(cost, viol1, mu_new)
        dphi = jr_dz - mu_new * viol1

        # Parallel backtracking line search on the retracted iterates.
        def trial(alpha):
            z_a = problem.retract(z, dz, alpha)
            r_a, c_a = problem.evaluate(z_a)
            return z_a, _merit(0.5 * torch.dot(r_a, r_a), c_l1(c_a), mu_new)

        z_trials, phi_trials = vmap(trial)(ls_alphas)
        phi_trials = torch.where(torch.isfinite(phi_trials), phi_trials,
                                 torch.inf)
        slack = config.merit_slack_ulps * eps * torch.abs(phi0)
        accepts = (phi_trials
                   <= phi0 + config.armijo_c1 * ls_alphas * dphi + slack)
        any_accept = torch.any(accepts) & qp_ok
        # The first acceptable alpha (the largest step), picked by index:
        # a one-hot product would turn a rejected trial's inf into NaN.
        first_idx = torch.argmax(accepts.to(dtype))
        alpha_used = torch.where(any_accept, take(ls_alphas, first_idx), 0.0)
        phi_new = torch.where(any_accept, take(phi_trials, first_idx), phi0)
        lam_next = torch.where(
            any_accept, lam * config.lambda_decrease,
            torch.clamp_min(lam * config.lambda_increase,
                            config.lambda_failure_floor))
        z_next = torch.where(any_accept, take(z_trials, first_idx), z)

        # Termination tests on the updated iterate; merit_prev is +inf on
        # the first iteration, kept out of the division.
        prev_ok = torch.isfinite(merit_prev)
        mp = torch.where(prev_ok, merit_prev, 0.0)
        rel_change = torch.where(
            prev_ok, torch.abs(mp - phi_new) / torch.clamp_min(
                torch.abs(mp), 1.0e-30), torch.inf)
        conv_rel = any_accept & (rel_change < config.relative_exit_tol)
        conv_first = first_order < config.absolute_first_derivative_tol
        fail_lambda = lam_next > config.lambda_max
        fail_qp = ~qp_ok
        S = NLSTerminationState
        new_term = torch.where(
            conv_first, S.SATISFIED_FIRST_ORDER_TOL, torch.where(
                conv_rel, S.SATISFIED_RELATIVE_TOL, torch.where(
                    fail_qp, S.QP_INDEFINITE, torch.where(
                        fail_lambda, S.MAX_LAMBDA,
                        S.MAX_ITERATIONS)))).to(torch.int32)
        now_done = conv_rel | conv_first | fail_lambda | fail_qp

        # Freeze finished instances.
        carry = (
            torch.where(done, z, z_next),
            torch.where(done, lam, lam_next),
            torch.where(done, mu, mu_new),
            torch.where(done, merit_prev, phi_new),
            done | now_done,
            torch.where(done, term, new_term),
            torch.where(done, fo_carry, first_order),
        )
        trace = (
            torch.where(done, torch.nan, cost),
            torch.where(done, torch.nan, c_inf(c)),
            torch.where(done, torch.nan, lam),
            torch.where(done, 0.0, alpha_used),
            torch.where(done, torch.nan, first_order),
            ~done,  # iteration applied?
        )
        return carry, trace

    carry = (
        z0,
        scalar(config.lambda_initial),
        scalar(config.equality_penalty_initial),
        scalar(torch.inf),
        torch.zeros((), dtype=torch.bool, device=device),
        torch.full((), NLSTerminationState.MAX_ITERATIONS, dtype=torch.int32,
                   device=device),
        scalar(torch.inf),
    )
    traces = []
    for _ in range(config.max_iterations):
        carry, trace = iteration(*carry)
        traces.append(trace)
    z, lam, _, _, _, term, first_order = carry
    iter_cost, iter_viol, iter_lambda, iter_alpha, iter_first, applied = (
        torch.stack(col, dim=-1) for col in zip(*traces))

    # Final cost and violation at the solution (one residual evaluation);
    # the first-order norm is the last applied iteration's.
    r, c = problem.evaluate(z)
    return z, NLSOutputs(
        termination_state=term,
        n_iterations=torch.sum(applied, dim=-1, dtype=torch.int32),
        cost=0.5 * torch.dot(r, r),
        constraint_violation=c_inf(c),
        first_order_norm=first_order,
        lambda_final=lam,
        iter_cost=iter_cost,
        iter_violation=iter_viol,
        iter_lambda=iter_lambda,
        iter_step_size=iter_alpha,
        iter_first_order=iter_first,
    )
