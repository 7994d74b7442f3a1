"""The fused damped Gauss-Newton iteration in plain PyTorch: a frozen copy
of the port's plain version of kernel 1 (``cartpole_tpu_torch/ops/fused.py``
at the commit that added the benchmark), with the kernel wrapper left out.
One iteration of the condensed lanes solver per instance, batch-last:
segment rollout with chain-ruled Jacobians, condensation, the spectral and
QR-Schur solves, the merit, the Armijo search over all trials, the LM
update, termination codes and the freeze of finished instances.
:func:`fused_solve` loops it on any device and dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Tuple

import numpy as np
import torch

from ..mpc.problem import _qr_gram_factor
from .integrate import mod_pi
from .lanes import rk4_step_rows, segment_rollout_with_jac_rows
from .solver import NLSConfig, NLSTerminationState, full_f32_matmul

__all__ = ["FusedStatics", "make_fused_statics", "fused_iteration_reference",
           "fused_solve", "full_f32_matmul"]

@dataclasses.dataclass(frozen=True)
class FusedStatics:
    """Everything an iteration needs besides the per-tick data: sizes,
    terminal-row specs, config scalars, and the static tensors on their
    device. Built once per (spec, config, dtype, device)."""

    model: str  #: the model's name, which picks its kernel instantiation
    sd: int
    n_p: int
    N: int
    sp: int
    K: int
    S: int
    n_u: int
    angle: Tuple[int, ...]
    term_costs: tuple
    term_eqs: tuple
    w_costs: Tuple[float, ...]
    D_diag: Tuple[float, ...]
    dt: float
    u_limit: float
    b_x_limit: float
    w_du: float
    w_u: float
    config: NLSConfig
    dyn_core: Callable
    jac_core: Callable
    Q: Any  #: (K, K) eigenbasis of the u-cost Gram matrix Hu.
    QT: Any  #: (K, K)
    eigs: Any  #: (K, 1) eigenvalues of Hu, clamped at 0.
    JuT: Any  #: (K, n_u) u-cost Jacobian, transposed.
    Juc: Any  #: (n_u, K)

    @property
    def n_tc(self) -> int:
        return len(self.term_costs)

    @property
    def n_t(self) -> int:
        return len(self.term_eqs)

    @property
    def n_ls(self) -> int:
        return self.config.max_line_search_iterations


def make_fused_statics(spec, config: NLSConfig, Hu_Q, Hu_eigs, Ju_cost,
                       D_diag, w_costs, dtype, device) -> FusedStatics:
    """Move the numpy statics of a ``_LanesProblem`` to ``device``."""
    p = spec.params
    K = spec.window_length

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device).contiguous()

    return FusedStatics(
        model=spec.model.name, sd=spec.state_dim,
        n_p=len(dataclasses.fields(spec.model.params_type)),
        N=spec.num_states, sp=spec.spacing, K=K,
        S=spec.num_states - 1, n_u=int(Ju_cost.shape[0]),
        angle=tuple(spec.model.angle_indices),
        term_costs=tuple(spec.terminal_costs),
        term_eqs=tuple(spec.terminal_eqs),
        w_costs=tuple(float(v) for v in w_costs),
        D_diag=tuple(float(v) for v in D_diag),
        dt=float(p.control_dt), u_limit=float(p.u_limit),
        b_x_limit=float(p.b_x_limit),
        w_du=float(p.u_derivative_cost_weight), w_u=float(p.u_cost_weight),
        config=config,
        dyn_core=spec.model.dynamics_core,
        jac_core=spec.model.dynamics_jac_core,
        Q=t(Hu_Q), QT=t(Hu_Q.T), eigs=t(Hu_eigs).reshape(K, 1),
        JuT=t(Ju_cost.T), Juc=t(Ju_cost),
    )


def _fold_sum(terms, like):
    """Sum of (literal-coefficient x tensor) products with 0/1 folding."""
    acc = None
    for coef, arr in terms:
        if isinstance(coef, (int, float)):
            if coef == 0.0:
                continue
            t = arr if coef == 1.0 else coef * arr
        else:
            t = coef * arr
        acc = t if acc is None else acc + t
    return torch.zeros_like(like) if acc is None else acc


def _row(e, s):
    """Segment ``s`` of a nested-tuple Jacobian entry (literals pass)."""
    return e if isinstance(e, (int, float)) else e[s]


def fused_iteration_reference(st: FusedStatics, params, xc, spt, up, xs, u,
                              lam, mu_pen, merit_prev, done, term,
                              fo_carry):
    """One damped-GN iteration, batch-last, in plain torch.

    ``params`` the model's params (fields 0-d or ``(B,)``), ``xc``
    ``(sd, B)``, ``spt``/``up`` ``(B,)``, carry ``xs (sd, N, B)``, ``u (K,
    B)``, ``lam``/``mu_pen``/``merit_prev``/``fo_carry`` ``(B,)``,
    ``done``/``term`` ``(B,)`` int32. Returns the 14 outputs in the
    kernel's order: the new carry (done as int32) then the traces
    ``cost, violation, lambda, alpha, first_order, applied``.
    """
    with full_f32_matmul():
        return _iteration_body(st, params, xc, spt, up, xs, u, lam, mu_pen,
                               merit_prev, done, term, fo_carry)


def _iteration_body(st, params, xc, spt, up, xs, u, lam, mu_pen, merit_prev,
                    done, term, fo_carry):
    sd, N, sp, K, S = st.sd, st.N, st.sp, st.K, st.S
    n_tc, n_t = st.n_tc, st.n_t
    n_all = n_tc + n_t
    cfg = st.config
    angle = st.angle
    dtype = u.dtype
    B = u.shape[-1]
    dt = st.dt
    w_du, w_u = st.w_du, st.w_u
    term_costs, term_eqs = st.term_costs, st.term_eqs
    w_costs, D_diag = st.w_costs, st.D_diag
    Q, QT, eigs, JuTm, Jucm = st.Q, st.QT, st.eigs, st.JuT, st.Juc
    alphas = [0.5 ** i for i in range(st.n_ls)]
    eps = float(torch.finfo(dtype).eps)
    done = done != 0
    xc = [xc[i] for i in range(sd)]
    xs = [xs[i] for i in range(sd)]

    def wrap(i, v):
        return mod_pi(v) if i in angle else v

    def target_of(ts):
        return spt if ts.is_setpoint else ts.target

    def cost_rows(xs_rows_last, u_arr, up_arr):
        r_term = []
        for ts, w in zip(term_costs, w_costs):
            diff = xs_rows_last[ts.coord] - target_of(ts)
            if ts.is_angle:
                diff = mod_pi(diff)
            r_term.append(w * diff)
        r_u = []
        if w_du > 0.0:
            r_u.append(w_du * (u_arr[:-1] - u_arr[1:]))
            r_u.append((w_du * (u_arr[0] - up_arr))[None])
        if w_u > 0.0:
            r_u.append(w_u * u_arr)
        r_u = torch.cat(r_u, dim=0) if r_u else u_arr.new_zeros(
            (0,) + tuple(u_arr.shape[1:]))
        return r_term, r_u

    def eq_rows(xs_rows_last):
        vals = []
        for ts in term_eqs:
            diff = xs_rows_last[ts.coord] - target_of(ts)
            if ts.is_angle:
                diff = mod_pi(diff)
            vals.append(diff)
        return vals

    # ================================================ condensed step
    x0_rows = tuple(xs[i][:-1] for i in range(sd))  # (S, B) each
    us_seg = u.reshape(S, sp, B).transpose(0, 1)  # (sp, S, B)
    x_end, Jx, Ju_cols = segment_rollout_with_jac_rows(
        lambda xr, u_: st.jac_core(params, xr, u_), x0_rows, us_seg, dt,
        angle,
    )
    defect = [wrap(i, x_end[i] - xs[i][1:]) for i in range(sd)]  # (S, B)
    pin = [wrap(i, xs[i][0] - xc[i]) for i in range(sd)]  # (B,)

    def jx_at(i, j, s):
        return _row(Jx[i][j], s)

    def ju_at(t, i, s):
        return _row(Ju_cols[t][i], s)

    # Forward condensation dx_s = M_s du + m_s.
    M = [u.new_zeros((K, B)) for _ in range(sd)]
    m = [-pin[i] for i in range(sd)]
    for s in range(S):
        M = [
            _fold_sum([(jx_at(i, j, s), M[j]) for j in range(sd)], M[i])
            for i in range(sd)
        ]
        for i in range(sd):
            Mi = M[i].clone()
            for t in range(sp):
                Mi[s * sp + t] = ju_at(t, i, s)
            M[i] = Mi
        m = [
            _fold_sum([(jx_at(i, j, s), m[j]) for j in range(sd)], m[i])
            + defect[i][s]
            for i in range(sd)
        ]

    xs_last = [xs[i][N - 1] for i in range(sd)]
    r_term, r_u = cost_rows(xs_last, u, up)
    term_J = [w_costs[t] * M[term_costs[t].coord] for t in range(n_tc)]
    term_aff = [w_costs[t] * m[term_costs[t].coord] for t in range(n_tc)]
    r_bar_term = [r_term[t] + term_aff[t] for t in range(n_tc)]
    U_costs = [M[ts.coord] for ts in term_costs]
    b_costs = [r_bar_term[t] / w_costs[t] for t in range(n_tc)]

    g_s = JuTm @ r_u  # (K, B)

    c_term = eq_rows(xs_last)
    A_eq = [M[ts.coord] for ts in term_eqs]
    c_bar = [c_term[j] + m[term_eqs[j].coord] for j in range(n_t)]

    A_all = U_costs + A_eq  # n_all entries of (K, B)
    b_all = b_costs + c_bar  # n_all entries of (B,)

    d_inv = 1.0 / (eigs + lam[None, :])  # (K, B)

    # Spectral solves, all right-hand sides in one pair of static matmuls.
    Xcat = torch.cat(A_all + [g_s], dim=1)  # (K, (n_all+1)B)
    Ycat = QT @ Xcat
    Dcat = torch.cat([d_inv] * (n_all + 1), dim=1)
    sol = Q @ (Ycat * Dcat)
    CiA = [sol[:, r * B:(r + 1) * B] for r in range(n_all)]
    Cig = sol[:, n_all * B:]

    if n_all:
        G = Q @ (Ycat[:, :n_all * B] * torch.sqrt(Dcat[:, :n_all * B]))
        cols = []
        for j in range(n_all):
            tail = u.new_zeros((n_all, B))
            tail[j] = float(np.sqrt(D_diag[j]))
            cols.append(torch.cat([G[:, j * B:(j + 1) * B], tail], dim=0))
        schur_solve = _qr_gram_factor(cols)
        mu_v = schur_solve(
            [b_all[r] - torch.sum(A_all[r] * Cig, dim=0)
             for r in range(n_all)]
        )  # (n_all, B)
        mu_rows = [mu_v[r] for r in range(n_all)]
        du = -(Cig + _fold_sum(
            [(1.0, CiA[r] * mu_rows[r][None, :]) for r in range(n_all)],
            Cig,
        ))
        # One refinement step on the augmented system.
        At_mu = _fold_sum(
            [(1.0, A_all[r] * mu_rows[r][None, :]) for r in range(n_all)],
            Cig,
        )
        c_mul_du = Q @ ((QT @ du) * (eigs + lam[None, :]))
        res_d = -g_s - (c_mul_du + At_mu)
        res_c = [
            -b_all[r]
            - (torch.sum(A_all[r] * du, dim=0) - D_diag[r] * mu_rows[r])
            for r in range(n_all)
        ]
        Ci_rd = Q @ ((QT @ res_d) * d_inv)
        e_y = schur_solve(
            [torch.sum(A_all[r] * Ci_rd, dim=0) - res_c[r]
             for r in range(n_all)]
        )
        e_rows = [e_y[r] for r in range(n_all)]
        du = du + Ci_rd - _fold_sum(
            [(1.0, CiA[r] * e_rows[r][None, :]) for r in range(n_all)], Cig,
        )
        mu_v = mu_v + e_y
        mu_rows = [mu_rows[r] + e_rows[r] for r in range(n_all)]
    else:
        mu_v = u.new_zeros((0, B))
        mu_rows = []
        du = -Cig
    mu_c = mu_rows[:n_tc]
    nu = mu_rows[n_tc:]

    # State-step expansion by the forward recursion.
    dx = [-pin[i] for i in range(sd)]
    dxs_rows = [list(dx)]
    for s in range(S):
        dx = [
            _fold_sum(
                [(jx_at(i, j, s), dx[j]) for j in range(sd)]
                + [(ju_at(t, i, s), du[s * sp + t]) for t in range(sp)],
                dx[i],
            )
            + defect[i][s]
            for i in range(sd)
        ]
        dxs_rows.append(list(dx))
    dxs = [torch.stack([dxs_rows[n][i] for n in range(N)]) for i in range(sd)]

    # Exact directional derivative (J^T r) . dz.
    Jdu_term = [torch.sum(term_J[t] * du, dim=0) for t in range(n_tc)]
    Jdu_u = Jucm @ du  # (n_u, B)
    jr_dz = _fold_sum(
        [(1.0, r_term[t] * (Jdu_term[t] + term_aff[t])) for t in range(n_tc)],
        lam,
    ) + torch.sum(r_u * Jdu_u, dim=0)

    # Post-step multiplier estimates for the merit ramp.
    gN = [u.new_zeros((B,)) for _ in range(sd)]
    for t in range(n_tc):
        gN[term_costs[t].coord] = gN[term_costs[t].coord] + mu_c[t]
    for j in range(n_t):
        gN[term_eqs[j].coord] = gN[term_eqs[j].coord] + nu[j]
    pi = list(gN)
    pi_max = u.new_zeros((B,))
    for s in reversed(range(S)):
        mags = torch.abs(pi[0])
        for i in range(1, sd):
            mags = torch.maximum(mags, torch.abs(pi[i]))
        pi_max = torch.maximum(pi_max, mags)
        pi = [
            _fold_sum([(jx_at(i, j, s), pi[i]) for i in range(sd)], pi[j])
            for j in range(sd)
        ]
    sigma_inf = torch.abs(pi[0])
    for i in range(1, sd):
        sigma_inf = torch.maximum(sigma_inf, torch.abs(pi[i]))
    if n_t:
        nu_abs = torch.abs(nu[0])
        for j in range(1, n_t):
            nu_abs = torch.maximum(nu_abs, torch.abs(nu[j]))
    else:
        nu_abs = u.new_zeros((B,))
    nu_inf = torch.maximum(nu_abs, torch.maximum(pi_max, sigma_inf))

    # Unified first-order diagnostic (pre-step residual multipliers).
    gN_pre = [u.new_zeros((B,)) for _ in range(sd)]
    for t in range(n_tc):
        c = term_costs[t].coord
        gN_pre[c] = gN_pre[c] + w_costs[t] * r_term[t]
    for j in range(n_t):
        c = term_eqs[j].coord
        gN_pre[c] = gN_pre[c] + nu[j]
    pi = list(gN_pre)
    gu_rows = [None] * K
    for s in reversed(range(S)):
        for t in range(sp):
            gu_rows[s * sp + t] = _fold_sum(
                [(ju_at(t, i, s), pi[i]) for i in range(sd)], pi[0]
            )
        pi = [
            _fold_sum([(jx_at(i, j, s), pi[i]) for i in range(sd)], pi[j])
            for j in range(sd)
        ]
    g_u_full = g_s + torch.stack(gu_rows)
    first_order = torch.amax(torch.abs(g_u_full), dim=0)

    qp_ok = torch.all(torch.isfinite(du), dim=0)
    for i in range(sd):
        qp_ok = qp_ok & torch.all(torch.isfinite(dxs[i]), dim=0)
    if n_all:
        qp_ok = qp_ok & torch.all(torch.isfinite(mu_v), dim=0)

    # ================================================ merit + trials
    cost = 0.5 * (
        _fold_sum([(1.0, r_term[t] ** 2) for t in range(n_tc)], lam)
        + torch.sum(r_u * r_u, dim=0)
    )
    viol1 = u.new_zeros((B,))
    for i in range(sd):
        viol1 = viol1 + torch.sum(torch.abs(defect[i]), dim=0)
        viol1 = viol1 + torch.abs(pin[i])
    for j in range(n_t):
        viol1 = viol1 + torch.abs(c_term[j])

    # Zero the step where the QP failed (fail_qp is terminal).
    du = torch.where(qp_ok[None, :], du, torch.zeros_like(du))
    dxs = [torch.where(qp_ok[None, :], dxs[i], torch.zeros_like(dxs[i]))
           for i in range(sd)]

    mu_new = torch.maximum(mu_pen, cfg.penalty_multiplier_margin * nu_inf)
    phi0 = cost + mu_new * viol1
    dphi = jr_dz - mu_new * viol1

    # All trials along a leading axis.
    def retract(a):
        ua = torch.clamp(u + a * du, -st.u_limit, st.u_limit)
        rows = []
        for i in range(sd):
            v = wrap(i, xs[i] + a * dxs[i])  # (N, B)
            if i == 0:
                v = torch.clamp(v, -st.b_x_limit, st.b_x_limit)
            rows.append(v)
        return ua, rows

    u_tr, xs_tr = zip(*[retract(a) for a in alphas])
    x0_tr = tuple(
        torch.stack([xs_tr[t][i][:-1] for t in range(st.n_ls)])
        for i in range(sd)
    )  # (n_ls, S, B)
    us_tr = torch.stack(u_tr).reshape(st.n_ls, S, sp, B)  # (n_ls, S, sp, B)
    x = x0_tr
    for t in range(sp):
        x = rk4_step_rows(lambda xr, u_: st.dyn_core(params, xr, u_), x,
                          us_tr[:, :, t], dt)
        x = tuple(wrap(i, x[i]) for i in range(sd))
    cost_a = u.new_zeros((st.n_ls, B))
    viol_a = u.new_zeros((st.n_ls, B))
    for i in range(sd):
        d_tr = wrap(
            i, x[i] - torch.stack([xs_tr[t][i][1:] for t in range(st.n_ls)])
        )  # (n_ls, S, B)
        viol_a = viol_a + torch.sum(torch.abs(d_tr), dim=1)
        pin_tr = wrap(
            i, torch.stack([xs_tr[t][i][0] for t in range(st.n_ls)])
            - xc[i][None, :]
        )
        viol_a = viol_a + torch.abs(pin_tr)
    last_tr = [
        torch.stack([xs_tr[t][i][N - 1] for t in range(st.n_ls)])
        for i in range(sd)
    ]
    rt_tr, ru_tr = cost_rows(last_tr, torch.stack(u_tr, dim=1), up[None, :])
    for t in range(n_tc):
        cost_a = cost_a + 0.5 * rt_tr[t] ** 2
    cost_a = cost_a + 0.5 * torch.sum(ru_tr * ru_tr, dim=0)
    for ce in eq_rows(last_tr):
        viol_a = viol_a + torch.abs(ce)

    phi_tr = cost_a + mu_new[None, :] * viol_a
    phi_tr = torch.where(torch.isfinite(phi_tr), phi_tr, math.inf)
    slack = cfg.merit_slack_ulps * eps * torch.abs(phi0)

    alpha_used = u.new_zeros((B,))
    phi_sel = u.new_zeros((B,))
    found = torch.zeros((B,), dtype=torch.bool, device=u.device)
    for t, a in enumerate(alphas):
        phi_t = phi_tr[t]
        acc_t = phi_t <= phi0 + cfg.armijo_c1 * (a * dphi) + slack
        take = acc_t & ~found
        alpha_used = torch.where(take, a, alpha_used)
        phi_sel = torch.where(take, phi_t, phi_sel)
        found = found | acc_t
    any_accept = found & qp_ok
    alpha_used = torch.where(any_accept, alpha_used,
                             torch.zeros_like(alpha_used))
    phi_new = torch.where(any_accept, phi_sel, phi0)

    # Accepted iterate: re-retract at the accepted alpha.
    u_acc, xs_acc = retract(alpha_used[None, :])

    lam_next = torch.where(
        any_accept,
        lam * cfg.lambda_decrease,
        torch.clamp_min(lam * cfg.lambda_increase, cfg.lambda_failure_floor),
    )
    u_next = torch.where(any_accept[None, :], u_acc, u)
    xs_next = [torch.where(any_accept[None, :], xs_acc[i], xs[i])
               for i in range(sd)]

    prev_ok = torch.isfinite(merit_prev)
    mp = torch.where(prev_ok, merit_prev, torch.zeros_like(merit_prev))
    rel_change = torch.where(
        prev_ok,
        torch.abs(mp - phi_new) / torch.clamp_min(torch.abs(mp), 1.0e-30),
        math.inf,
    )
    conv_rel = any_accept & (rel_change < cfg.relative_exit_tol)
    conv_first = first_order < cfg.absolute_first_derivative_tol
    fail_lambda = lam_next > cfg.lambda_max
    fail_qp = ~qp_ok

    T_ = NLSTerminationState
    new_term = torch.where(
        conv_first, T_.SATISFIED_FIRST_ORDER_TOL,
        torch.where(
            conv_rel, T_.SATISFIED_RELATIVE_TOL,
            torch.where(
                fail_qp, T_.QP_INDEFINITE,
                torch.where(fail_lambda, T_.MAX_LAMBDA, T_.MAX_ITERATIONS),
            ),
        ),
    ).to(torch.int32)
    now_done = conv_rel | conv_first | fail_lambda | fail_qp

    xs_out = torch.stack(
        [torch.where(done[None, :], xs[i], xs_next[i]) for i in range(sd)]
    )  # (sd, N, B)
    u_out = torch.where(done[None, :], u, u_next)
    lam_out = torch.where(done, lam, lam_next)
    mu_out = torch.where(done, mu_pen, mu_new)
    merit_out = torch.where(done, merit_prev, phi_new)
    term_out = torch.where(done, term, new_term)
    fo_out = torch.where(done, fo_carry, first_order)
    done_out = done | now_done

    violmax = u.new_zeros((B,))
    for i in range(sd):
        violmax = torch.maximum(violmax,
                                torch.amax(torch.abs(defect[i]), dim=0))
        violmax = torch.maximum(violmax, torch.abs(pin[i]))
    for j in range(n_t):
        violmax = torch.maximum(violmax, torch.abs(c_term[j]))

    nan = math.nan
    return (
        xs_out, u_out, lam_out, mu_out, merit_out,
        done_out.to(torch.int32), term_out, fo_out,
        torch.where(done, nan, cost),
        torch.where(done, nan, violmax),
        torch.where(done, nan, lam),
        torch.where(done, torch.zeros_like(alpha_used), alpha_used),
        torch.where(done, nan, first_order),
        (~done).to(torch.int32),
    )


def fused_solve(st: FusedStatics, params, xc, spt, up, carry, n_iter: int):
    """``n_iter`` plain iterations from ``carry = (xs, u, lam, mu, merit,
    done, term, fo)`` (done/term int32). Returns ``(carry, traces)`` with
    traces ``(cost, violation, lambda, alpha, first_order, applied)`` each
    ``(n_iter, B)``."""
    rows = []
    for _ in range(n_iter):
        outs = fused_iteration_reference(st, params, xc, spt, up, *carry)
        carry, tr = outs[:8], outs[8:]
        rows.append(tr)
    traces = tuple(torch.stack([r[k] for r in rows]) for k in range(6))
    return carry, traces
