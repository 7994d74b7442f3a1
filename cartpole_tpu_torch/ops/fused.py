"""The fused damped Gauss-Newton iteration: plain PyTorch version and the
wrapper of its Hopper kernel.

Replaces ``cartpole_tpu/ops/fused.py::make_fused_iteration`` (the Pallas
megakernel, tile ``body`` at ``ops/fused.py:214-743``). One iteration of the
condensed lanes solver, per instance: segment rollout with chain-ruled
Jacobians, defects and pins, forward condensation ``dx_s = M_s du + m_s``,
cost rows and ``g = Ju^T r_u``, spectral ``C^{-1}`` / ``C^{-1/2}`` solves in
the static eigenbasis, the 2-pass MGS QR-Schur solve of all terminal rows
with one refinement step, state-step expansion, ``(J^T r) . dz``, the
adjoint passes for ``nu_inf`` and ``first_order``, ``qp_ok``, the L1 merit
with its penalty ramp, the ``n_ls``-trial Armijo search, acceptance, the LM
lambda update, termination codes, the freeze of finished instances and six
traces.

* :func:`fused_iteration_reference` is a direct torch translation of that
  body, dtype-generic (f64 in the CPU tests, f32 on the card when it is
  held against the kernel). The TPU layout workarounds (one-hot row-mask
  splice, static ``_at`` slicing, ``(1, B)`` rows) are gone; the arithmetic
  and its order are kept.
* :func:`fused_solve` runs ``n_iter`` iterations. On CPU tensors it loops
  the plain version; on CUDA tensors it launches the kernel of
  ``csrc/fused_iteration.cu`` once (the reference's ``single_launch``
  semantics) or raises — it never falls back. The kernel gives each
  instance :data:`LANES_PER_INSTANCE` lanes of a warp and a workspace in
  shared memory, :data:`INSTANCES_PER_BLOCK` instances to a block.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import math
from typing import Any, Callable, Tuple

import numpy as np
import torch

from ..mpc.problem import _qr_gram_factor
from .integrate import mod_pi
from .lanes import rk4_step_rows, segment_rollout_with_jac_rows
from ._build import KERNEL_MODELS
from .solver import NLSConfig, NLSTerminationState

__all__ = ["FusedStatics", "make_fused_statics", "fused_iteration_reference",
           "fused_solve", "fused_supported", "full_f32_matmul"]

#: The range the kernel is built and tested for: window, shooting states
#: and line-search trials. A model's terminal rows are at most its state
#: dimension (``fused::Body::ALLMAX``); the config struct holds
#: :data:`ROWS_MAX`, the largest (``fused::ROWS_MAX``).
KMAX, NMAX, LSMAX = 64, 17, 8
ROWS_MAX = 8
#: Lanes per instance, as compiled (``FUSED_LANES`` of
#: csrc/fused_iteration.cu), and instances per block; chosen on the card
#: (PERF.md, kernel 1).
LANES_PER_INSTANCE = 16
INSTANCES_PER_BLOCK = 4
#: Shared memory a block may use on an H100, and the per-instance scalars
#: at the head of a workspace (``fused::N_SCALARS``).
SMEM_BLOCK_MAX = 232448
N_SCALARS = 22


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


@contextlib.contextmanager
def full_f32_matmul():
    """Run f32 matmuls at full f32 precision (no TF32, no bf16 passes) for
    the duration, whatever the caller's global setting, and restore that
    setting on exit, as the reference pins HIGHEST precision
    (mpc/lanes.py:552, ops/fused.py:209-211). Uses the per-backend
    ``fp32_precision`` settings where torch has them (mixing them with the
    global getter raises there), else the global one."""
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


def fused_supported(problem, config) -> bool:
    """Whether the fused kernel covers this problem configuration
    (reference ``ops/fused.py:60-70``): generated-core dynamics, dynamics
    params 0-d or per-instance ``(B,)``, and no equality re-basing with
    terminal equalities."""
    spec = problem.spec
    model = spec.model
    if model.dynamics_jac_core is None or model.dynamics_core is None:
        return False
    if spec.params.rebase_equalities and len(spec.terminal_eqs):
        return False
    return all(tuple(getattr(leaf, "shape", ())) in ((), (problem.B,))
               for leaf in problem.dynamics_params.as_tuple())


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


# ------------------------------------------------------------------ kernel
def _args_struct(real):
    """``FusedArgs<T>`` of csrc/fused_iteration.cuh (passed by value) for
    ``real`` = c_float or c_double."""
    return type("FusedArgs", (ctypes.Structure,), {"_fields_": (
        [(n, ctypes.c_int) for n in (
            "B", "K", "N", "S", "sp", "n_u", "n_tc", "n_t", "n_ls",
            "n_iter", "angle_mask")]
        + [(n, ctypes.c_int * ROWS_MAX) for n in (
            "row_coord", "row_is_angle", "row_is_setpoint")]
        + [(n, real * ROWS_MAX) for n in (
            "row_target", "w_costs", "D_diag", "sqrtD")]
        + [(n, real) for n in (
            "dt", "h_half", "h_sixth", "u_limit", "b_x_limit", "w_du", "w_u",
            "penalty_margin", "armijo_c1", "slack_coef", "lambda_decrease",
            "lambda_increase", "lambda_failure_floor", "lambda_max",
            "relative_exit_tol", "abs_first_tol")]
    )})


_ArgsF = _args_struct(ctypes.c_float)
_ArgsD = _args_struct(ctypes.c_double)


_TENSOR_FIELDS = (
    "params", "Q", "eigs", "Juc", "xc", "spt", "up",
    "xs", "u", "lam", "mu", "merit", "done", "term", "fo",
    "xs_o", "u_o", "lam_o", "mu_o", "merit_o", "done_o", "term_o", "fo_o",
    "tr_cost", "tr_viol", "tr_lam", "tr_alpha", "tr_first", "tr_applied",
)


class _Tensors(ctypes.Structure):
    """``FusedTensors<T>``: one pointer per field."""

    _fields_ = [(n, ctypes.c_void_p) for n in _TENSOR_FIELDS]


def kernel_args(st: FusedStatics, B: int, n_iter: int, double=False):
    """The by-value config struct of the kernel: ``FusedArgs<float>`` for
    the card, ``FusedArgs<double>`` for the host build. Scalars derived from
    the config (dt/2, dt/6, the merit slack) are formed in double and then
    rounded, as the reference forms them."""
    rows = list(st.term_costs) + list(st.term_eqs)
    cfg = st.config
    eps = float(np.finfo(np.float64 if double else np.float32).eps)
    a = (_ArgsD if double else _ArgsF)()
    for name, val in dict(
        B=B, K=st.K, N=st.N, S=st.S, sp=st.sp, n_u=st.n_u, n_tc=st.n_tc,
        n_t=st.n_t, n_ls=st.n_ls, n_iter=n_iter,
        angle_mask=sum(1 << i for i in st.angle),
        dt=st.dt, h_half=st.dt * 0.5, h_sixth=st.dt / 6.0,
        u_limit=st.u_limit, b_x_limit=st.b_x_limit, w_du=st.w_du,
        w_u=st.w_u, penalty_margin=cfg.penalty_multiplier_margin,
        armijo_c1=cfg.armijo_c1, slack_coef=cfg.merit_slack_ulps * eps,
        lambda_decrease=cfg.lambda_decrease,
        lambda_increase=cfg.lambda_increase,
        lambda_failure_floor=cfg.lambda_failure_floor,
        lambda_max=cfg.lambda_max, relative_exit_tol=cfg.relative_exit_tol,
        abs_first_tol=cfg.absolute_first_derivative_tol,
    ).items():
        setattr(a, name, val)
    for r, ts in enumerate(rows):
        a.row_coord[r] = ts.coord
        a.row_is_angle[r] = int(ts.is_angle)
        a.row_is_setpoint[r] = int(ts.is_setpoint)
        a.row_target[r] = ts.target
        a.D_diag[r] = st.D_diag[r]
        a.sqrtD[r] = float(np.sqrt(st.D_diag[r]))
        if r < st.n_tc:
            a.w_costs[r] = st.w_costs[r]
    return a


def workspace_reals(st: FusedStatics, lanes: int = LANES_PER_INSTANCE) -> int:
    """Reals of one instance's shared workspace: ``fused::Body::make_layout``
    of csrc/fused_iteration.cuh for the model's state dimension ``sd``,
    parameter count ``n_p`` and ``sd`` terminal-row slots. The KKT solve's
    buffers, what the adjoint stage hands on, and the line-search trials
    share one region."""
    K, N, S, n_u, sd = st.K, st.N, st.S, st.n_u, st.sd
    n_all = st.n_tc + st.n_t
    fixed = (N_SCALARS + st.n_p + sd + sd * N + K + S * sd * sd + K * sd
             + S * sd + sd + sd * K + sd + 10 * sd + sd * sd
             + n_u + 5 * K + N * sd)
    solve = (n_all + 1) * K + n_all * K + K + n_all * (K + n_all) + 3 * K
    post = n_u + S * sd
    P = min(max(1, lanes // S), st.n_ls)
    trials = P * (N * sd + K + S * sd + n_u + 2)
    return fixed + max(solve, post, trials)


def statics_reals(st: FusedStatics) -> int:
    """Reals of a block's statics in shared memory: Q at row stride K + 1,
    and eigs (Juc is read from device memory)."""
    return st.K * (st.K + 1) + st.K


def block_shape(st: FusedStatics, itemsize: int = 4):
    """``(instances per block, shared bytes per block)`` of a launch:
    :data:`INSTANCES_PER_BLOCK`, fewer where their workspaces would not fit
    in :data:`SMEM_BLOCK_MAX`."""
    ws = workspace_reals(st) * itemsize
    statics = statics_reals(st) * itemsize
    w = max(1, min(INSTANCES_PER_BLOCK, (SMEM_BLOCK_MAX - statics) // ws))
    return w, statics + w * ws


def check_sizes(st: FusedStatics):
    """Raise on a model without a compiled instantiation, where one
    instance's shared workspace beside the block's statics would not fit in
    a block, and on a configuration beyond the kernel's tested range."""
    n_all = st.n_tc + st.n_t
    if st.model not in KERNEL_MODELS:
        raise ValueError(f"fused kernel has no compiled dynamics for model "
                         f"{st.model!r} (compiled: {KERNEL_MODELS})")
    ws, statics = 4 * workspace_reals(st), 4 * statics_reals(st)
    if statics + ws > SMEM_BLOCK_MAX:
        raise ValueError(
            f"fused kernel shared memory: the statics take {statics} B and "
            f"one instance's workspace {ws} B, above the {SMEM_BLOCK_MAX} B "
            f"a block may use (K={st.K}, N={st.N}, n_u={st.n_u}, "
            f"n_all={n_all})"
        )
    if not (st.K <= KMAX and st.N <= NMAX and n_all <= st.sd
            and st.n_ls <= LSMAX and st.n_u <= 2 * KMAX):
        raise ValueError(
            f"fused kernel limits K<={KMAX}, N<={NMAX}, n_all<={st.sd}, "
            f"n_ls<={LSMAX}; got K={st.K}, N={st.N}, n_all={n_all}, "
            f"n_ls={st.n_ls}"
        )


def params_block(params, B, dtype, device):
    """``(n_p, B)`` contiguous block of the dynamics params: scalar fields
    are broadcast, so one kernel covers both reference variants."""
    return torch.stack([
        torch.broadcast_to(torch.as_tensor(v, dtype=dtype, device=device),
                           (B,))
        for v in params.as_tuple()
    ]).contiguous()


def kernel_io(st: FusedStatics, params, xc, spt, up, xs, u, lam, mu, merit,
              done, term, fo, n_iter: int):
    """Check the inputs against the kernel's layout and allocate its
    outputs. Returns ``(ptrs, carry, traces, keep)``: the ``FusedTensors``
    pointer struct, the output tensors it points into, and every tensor it
    points at, which the caller holds until the launch is enqueued (the
    params block exists only here). Works for any device and real type, so
    the host build of the kernel body shares it."""
    dtype = u.dtype
    check_sizes(st)
    B = u.shape[-1]
    dev = u.device
    ins = dict(
        params=params_block(params, B, dtype, dev),
        Q=st.Q, eigs=st.eigs, Juc=st.Juc, xc=xc, spt=spt, up=up, xs=xs, u=u,
        lam=lam, mu=mu, merit=merit, done=done, term=term, fo=fo,
    )
    shapes = dict(
        params=(st.n_p, B), Q=(st.K, st.K), eigs=(st.K, 1), Juc=(st.n_u, st.K),
        xc=(st.sd, B), spt=(B,), up=(B,), xs=(st.sd, st.N, B), u=(st.K, B),
        lam=(B,), mu=(B,), merit=(B,), done=(B,), term=(B,), fo=(B,),
    )
    for name, t in ins.items():
        want = torch.int32 if name in ("done", "term") else dtype
        if (t.device != dev or t.dtype != want
                or tuple(t.shape) != shapes[name] or not t.is_contiguous()):
            raise ValueError(
                f"fused kernel input {name}: expected contiguous {want} "
                f"{shapes[name]} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
            )
    carry = (torch.empty_like(xs), torch.empty_like(u), torch.empty_like(lam),
             torch.empty_like(mu), torch.empty_like(merit),
             torch.empty_like(done), torch.empty_like(term),
             torch.empty_like(fo))
    traces = tuple(
        torch.empty((n_iter, B), dtype=dtype, device=dev) for _ in range(5)
    ) + (torch.empty((n_iter, B), dtype=torch.int32, device=dev),)
    tensors = {**ins, **dict(zip(_TENSOR_FIELDS[15:], carry + traces))}
    ptrs = _Tensors(**{n: tensors[n].data_ptr() for n in _TENSOR_FIELDS})
    return ptrs, carry, traces, tensors


def _launch_cuda(st, params, xc, spt, up, carry, n_iter, lib=None,
                 lanes=LANES_PER_INSTANCE, instances=None):
    """One launch of the kernel; ``lib``, ``lanes`` and ``instances`` name
    another build of it (``ops/_build.build_library`` with
    ``-DFUSED_LANES``) and another block size, as a layout sweep needs."""
    from ._build import load_library

    if carry[1].dtype != torch.float32:
        raise TypeError(f"fused kernel is f32-only, got {carry[1].dtype}")
    ptrs, carry_o, traces, keep = kernel_io(st, params, xc, spt, up,
                                            *carry, n_iter)
    dev = carry[1].device
    lib = lib or load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.fused_iteration_launch_f32(
            KERNEL_MODELS.index(st.model), ptrs,
            kernel_args(st, carry[1].shape[-1], n_iter), lanes,
            instances or block_shape(st)[0], stream)
    del keep  # the launch is enqueued: stream order protects the inputs
    if rc != 0:
        raise RuntimeError(f"fused_iteration kernel launch failed: CUDA "
                           f"error {rc}")
    fused_solve.launches += 1
    return carry_o, traces


def kernel_occupancy(st: FusedStatics, B: int, instances=None, lib=None):
    """What a launch of the kernel at batch ``B`` gets on the current card,
    as the CUDA runtime reports it: lanes per instance, workspace reals
    per instance, instances and shared bytes per block, resident blocks
    (and warps) per SM, registers and local (spill) bytes per thread."""
    from ._build import load_library

    check_sizes(st)
    w = instances or block_shape(st)[0]
    out = (ctypes.c_int * 6)()
    rc = (lib or load_library()).fused_iteration_occupancy_f32(
        KERNEL_MODELS.index(st.model), kernel_args(st, B, 1), w, out)
    if rc != 0:
        raise RuntimeError(f"fused_iteration occupancy query failed: CUDA "
                           f"error {rc}")
    return dict(lanes=out[0], workspace_reals=out[1], instances_per_block=w,
                smem_per_block=out[2], blocks_per_sm=out[3],
                resident_warps_per_sm=out[3] * w * out[0] / 32,
                registers=out[4], local_bytes=out[5])


def fused_solve(st: FusedStatics, params, xc, spt, up, carry, n_iter: int):
    """``n_iter`` fused iterations from ``carry = (xs, u, lam, mu, merit,
    done, term, fo)`` (done/term int32). Returns ``(carry, traces)`` with
    traces ``(cost, violation, lambda, alpha, first_order, applied)`` each
    ``(n_iter, B)``.

    CPU tensors run :func:`fused_iteration_reference` ``n_iter`` times. CUDA
    tensors launch the kernel once, which loops the iterations in each
    instance's lanes; an f64 input, a size beyond the kernel's range or a
    missing library raises. ``fused_solve.launches`` counts kernel launches.
    """
    if carry[1].device.type == "cuda":
        return _launch_cuda(st, params, xc, spt, up, carry, n_iter)
    if carry[1].device.type != "cpu":
        raise ValueError(f"fused_solve: unsupported device "
                         f"{carry[1].device}")
    rows = []
    for _ in range(n_iter):
        outs = fused_iteration_reference(st, params, xc, spt, up, *carry)
        carry, tr = outs[:8], outs[8:]
        rows.append(tr)
    traces = tuple(torch.stack([r[k] for r in rows]) for k in range(6))
    return carry, traces


fused_solve.launches = 0
