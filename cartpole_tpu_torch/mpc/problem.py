"""The multiple-shooting MPC problem (counterpart of
``cartpole_tpu/mpc/problem.py``): its static structure, the QR-Schur
helpers, and the per-instance problem closures of the generic solve
(``make_problem_fns``: linearize, evaluate, retract) and of its condensed
KKT path (``make_condensed_step``).

Decision vector layout matches the reference (``optimization.cc:24-37``)::

    z = [x(0), x(1), ..., x(N-1), u(0), ..., u(K-1)],  dim = N*sd + K

The static structure is plain numpy, built once per spec; its device
copies are made once per dtype and device (``_consts``), never inside a
tick. The QR helpers work on the column-list form: each column is a tensor
whose leading axis is the column's rows and whose trailing axes are the
batch. The per-instance closures take one decision vector ``(dim,)``:
segment Jacobians come from ``torch.func.vmap(torch.func.jacrev(...))``
over the segments, or from the generated analytic Jacobians with
``analytic_jacobians``. (The reference takes ``jax.jacfwd``, measured the
faster on its TPU; torch's forward mode sends every operation between a
dual number and a constant through a Python decomposition, 3-5x slower
than reverse mode here, for the same Jacobian to rounding.) Each
``lax.scan`` over the segments is a Python loop; no update is in place, so
the closures run under ``vmap``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
from torch.func import jacrev, vmap

from ..models.base import CartPoleModel
from ..ops.integrate import (mod_pi, rollout, segment_rollout_with_jac,
                             wrap_angles)
from ..ops.solver import cho_solve, cholesky
from .config import OptimizationParams

__all__ = ["TerminalSpec", "MPCProblemSpec"]


def _mgs_qr(cols):
    """2-pass modified-Gram-Schmidt QR of a tall-skinny matrix given as a
    list of ``n`` columns, each ``(m, ...)``.

    Returns ``(qs, R)``: ``qs`` the orthonormal columns and ``R`` an
    ``n x n`` list-of-lists of per-instance scalars (upper triangular,
    ``R[i][j]`` set for ``i <= j``). Two passes restore orthogonality to
    ~eps ("twice is enough"); a relative floor on each pivot guards rank
    collapse (1e-6 in f32, 1e-14 in f64)."""
    cols = list(cols)
    n = len(cols)
    eps_rel = 1.0e-6 if cols[0].dtype == torch.float32 else 1.0e-14
    R = [[None] * n for _ in range(n)]
    qs = []
    for j in range(n):
        v = cols[j]
        orig_norm = torch.sqrt(torch.sum(v * v, dim=0))
        rj = [torch.zeros_like(orig_norm) for _ in range(j)]
        for _pass in range(2):
            for i in range(j):
                h = torch.sum(qs[i] * v, dim=0)
                v = v - h * qs[i]
                rj[i] = rj[i] + h
        nrm = torch.sqrt(torch.sum(v * v, dim=0))
        nrm = torch.maximum(nrm, eps_rel * orig_norm + 1.0e-30)
        for i in range(j):
            R[i][j] = rj[i]
        R[j][j] = nrm
        qs.append(v / nrm)
    return qs, R


def _tri_rt_solve(R, b):
    """Solve ``R^T y = b`` (forward substitution) for upper-triangular
    ``R`` from :func:`_mgs_qr`; ``b`` a length-``n`` sequence of rows."""
    n = len(R)
    y = [None] * n
    for i in range(n):
        acc = b[i]
        for k in range(i):
            acc = acc - R[k][i] * y[k]
        y[i] = acc / R[i][i]
    return y


def _tri_r_solve(R, b):
    """Solve ``R x = b`` (back substitution) for upper-triangular ``R``."""
    n = len(R)
    x = [None] * n
    for i in reversed(range(n)):
        acc = b[i]
        for k in range(i + 1, n):
            acc = acc - R[i][k] * x[k]
        x[i] = acc / R[i][i]
    return x


def _qr_gram_factor(cols):
    """Factor a tall-skinny matrix ``T`` (list of columns) and return
    ``solve(b)`` computing ``(T^T T)^{-1} b`` through the R factor of a
    2-pass MGS QR plus triangular substitutions — the Gram matrix is never
    formed (forming it squares cond(T) into the f32 entries)."""
    _qs, R = _mgs_qr(cols)

    def solve(b):
        return torch.stack(_tri_r_solve(R, _tri_rt_solve(R, b)))

    return solve


@dataclasses.dataclass(frozen=True)
class TerminalSpec:
    """One terminal-state objective: cost row (weight >= 0) or equality row."""

    coord: int  #: state coordinate index at the terminal shooting state.
    target: float  #: static target (ignored when is_setpoint).
    weight: float  #: residual weight (1.0 for equality rows).
    is_angle: bool  #: wrap the difference with mod_pi.
    is_setpoint: bool  #: target is the dynamic b_x set-point argument.


class MPCProblemSpec:
    """Precomputed static structure of the multiple-shooting NLS problem."""

    def __init__(self, params: OptimizationParams, model: CartPoleModel):
        self.params = params
        self.model = model
        sd = model.state_dim
        K = params.window_length
        spacing = params.state_spacing
        N = params.num_states

        self.state_dim = sd
        self.num_states = N
        self.window_length = K
        self.spacing = spacing
        self.u_start = N * sd
        self.dim = N * sd + K
        self.n_defect = (N - 1) * sd

        n_q = sd // 2
        # Terminal objective coordinates in reference order:
        # b_x, angle(s), b_x_dot, angle rate(s) (optimization.cc:236-267).
        coord_specs = [(0, 0.0, params.b_x_final_cost_weight, False, True)]
        for a in model.angle_indices:
            coord_specs.append(
                (a, math.pi / 2, params.th_final_cost_weight, True, False))
        coord_specs.append(
            (n_q, 0.0, params.b_x_dot_final_cost_weight, False, False))
        for a in model.angle_indices:
            coord_specs.append(
                (a + n_q, 0.0, params.th_dot_final_cost_weight, False, False))

        # Zero-weight rows are dropped; a negative weight makes the row an
        # equality constraint with unit weight (optimization.cc:236-267).
        self.terminal_costs: Tuple[TerminalSpec, ...] = tuple(
            TerminalSpec(c, t, w, ang, sp)
            for (c, t, w, ang, sp) in coord_specs if w > 0.0
        )
        self.terminal_eqs: Tuple[TerminalSpec, ...] = tuple(
            TerminalSpec(c, t, 1.0, ang, sp)
            for (c, t, w, ang, sp) in coord_specs if w < 0.0
        )
        self._build_static_structure()

    def _x_off(self, s: int) -> int:
        return s * self.state_dim

    def _build_static_structure(self):
        p, sd, N, K = (self.params, self.state_dim, self.num_states,
                       self.window_length)
        D, u0 = self.dim, self.u_start
        xN = self._x_off(N - 1)

        # Constant cost Jacobian (all cost residuals are linear in z).
        rows = []
        for spec in self.terminal_costs:
            row = np.zeros(D)
            row[xN + spec.coord] = spec.weight
            rows.append(row)
        if p.u_derivative_cost_weight > 0.0:
            w = p.u_derivative_cost_weight
            for k in range(K - 1):
                row = np.zeros(D)
                row[u0 + k] = w
                row[u0 + k + 1] = -w
                rows.append(row)
            row = np.zeros(D)  # continuity with previous iteration's u(0).
            row[u0] = w
            rows.append(row)
        if p.u_cost_weight > 0.0:
            for k in range(K):
                row = np.zeros(D)
                row[u0 + k] = p.u_cost_weight
                rows.append(row)
        self.n_res = len(rows)
        self._J_cost = np.stack(rows) if rows else np.zeros((0, D))

        # Constant Jacobian of the linear equality rows: initial-state pins
        # (optimization.cc:228-232) then terminal equalities.
        lin_rows = []
        for i in range(sd):
            row = np.zeros(D)
            row[i] = 1.0
            lin_rows.append(row)
        for spec in self.terminal_eqs:
            row = np.zeros(D)
            row[xN + spec.coord] = 1.0
            lin_rows.append(row)
        self._A_lin = np.stack(lin_rows)
        self.n_eq = self.n_defect + self._A_lin.shape[0]

        # Block-bidiagonal selection masks for defect-Jacobian assembly.
        self._sel_this = np.eye(N - 1, N)  # segment s -> state s
        self._sel_next = np.eye(N - 1, N, k=1)  # segment s -> state s+1

        # u-only part of the cost Jacobian (the condensed path's static
        # Gram matrix is built from it).
        u_rows = []
        if p.u_derivative_cost_weight > 0.0:
            w = p.u_derivative_cost_weight
            for k in range(K - 1):
                row = np.zeros(K)
                row[k] = w
                row[k + 1] = -w
                u_rows.append(row)
            row = np.zeros(K)
            row[0] = w
            u_rows.append(row)
        if p.u_cost_weight > 0.0:
            for k in range(K):
                row = np.zeros(K)
                row[k] = p.u_cost_weight
                u_rows.append(row)
        self._J_cost_u = np.stack(u_rows) if u_rows else np.zeros((0, K))

        # Retraction masks (optimization.cc:309-329).
        angle_mask = np.zeros(D, bool)
        pos_mask = np.zeros(D, bool)
        u_mask = np.zeros(D, bool)
        for s in range(N):
            for a in self.model.angle_indices:
                angle_mask[self._x_off(s) + a] = True
            pos_mask[self._x_off(s)] = True
        u_mask[u0:] = True
        self._angle_mask = angle_mask
        self._pos_mask = pos_mask
        self._u_mask = u_mask
        self._consts_cache: dict = {}

    # ------------------------------------------------ device copies of statics
    def _consts(self, dtype, device) -> dict:
        """The static matrices and masks as tensors on ``device``, made on
        first use for each (dtype, device) and kept: a copy from the host
        inside a tick would wait for the card."""
        key = (dtype, str(device))
        if key not in self._consts_cache:
            def t(a):
                return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                       device=device)

            def b(a):
                return torch.as_tensor(a, device=device)

            w_costs = np.asarray([ts.weight for ts in self.terminal_costs],
                                 np.float64)
            D_diag = np.concatenate([1.0 / w_costs ** 2,
                                     np.full(len(self.terminal_eqs), 1e-12)])
            D = t(D_diag)
            self._consts_cache[key] = dict(
                J_cost=t(self._J_cost), J_cost_u=t(self._J_cost_u),
                A_lin=t(self._A_lin), sel_this=t(self._sel_this),
                sel_next=t(self._sel_next),
                Hu=t(self._J_cost_u.T @ self._J_cost_u),
                w_costs=t(w_costs), D_diag=D,
                sqrt_D=torch.diag(torch.sqrt(D)),
                angle_mask=b(self._angle_mask), pos_mask=b(self._pos_mask),
                u_mask=b(self._u_mask))
        return self._consts_cache[key]

    # ------------------------------------------------------------------ pieces
    def _split(self, z):
        """z -> (states (N, sd), per-segment controls (N-1, spacing))."""
        xs = z[: self.u_start].reshape(self.num_states, self.state_dim)
        useg = z[self.u_start:].reshape(self.num_states - 1, self.spacing)
        return xs, useg

    def _segment_fn(self, dynamics_params):
        """x(s), u_seg -> the state integrated over one shooting segment
        (``optimization.cc:117-137``)."""
        model, p = self.model, self.params

        def f(x, u):
            return model.dynamics(dynamics_params, x, u)

        def segment(x_s, u_seg):
            return rollout(f, x_s, u_seg, p.control_dt,
                           model.angle_indices)[0]

        return segment

    def _segment_jac_fn(self, dynamics_params):
        """Batched over segments: ``(xs, usegs) -> ((Jx, Ju), x_end)``.

        With ``params.analytic_jacobians`` the generated closed-form
        dynamics Jacobians are chained through
        :func:`segment_rollout_with_jac`; otherwise reverse-mode AD of the
        segment rollout, one pass for each of its ``sd`` outputs (module
        docstring)."""
        model, p = self.model, self.params
        if p.analytic_jacobians:
            def fj(x, u):
                return model.dynamics_jac(dynamics_params, x, u)

            def seg(x_s, u_seg):
                x_end, Jx, Ju = segment_rollout_with_jac(
                    fj, x_s, u_seg, p.control_dt, model.angle_indices)
                return (Jx, Ju), x_end

            return vmap(seg)

        segment = self._segment_fn(dynamics_params)

        def seg_with_aux(x_s, u_seg):
            x_end = segment(x_s, u_seg)
            return x_end, x_end

        return vmap(jacrev(seg_with_aux, argnums=(0, 1), has_aux=True))

    def _wrap_defect(self, diff):
        """mod_pi the angle components of a (..., sd) state difference
        (``optimization.cc:156-158``)."""
        return wrap_angles(diff, self.model.angle_indices)

    @staticmethod
    def _target_diff(x, spec: TerminalSpec, set_point):
        diff = x[spec.coord] - (set_point if spec.is_setpoint
                                else spec.target)
        return mod_pi(diff) if spec.is_angle else diff

    def cost_residuals(self, z, set_point, u_prev):
        """Weighted cost residual vector r(z) (least-squares form)."""
        xN = z[self._x_off(self.num_states - 1): self.u_start]
        pieces = [(spec.weight * self._target_diff(xN, spec, set_point))
                  .reshape(1) for spec in self.terminal_costs]
        u = z[self.u_start:]
        p = self.params
        if p.u_derivative_cost_weight > 0.0:
            w = p.u_derivative_cost_weight
            pieces.append(w * (u[:-1] - u[1:]))
            pieces.append((w * (u[0] - u_prev)).reshape(1))
        if p.u_cost_weight > 0.0:
            pieces.append(p.u_cost_weight * u)
        if not pieces:
            return z.new_zeros((0,))
        return torch.cat(pieces)

    def _linear_eq_residuals(self, xs, x_current, set_point):
        pieces = [self._wrap_defect(xs[0] - x_current)]
        pieces += [self._target_diff(xs[-1], spec, set_point).reshape(1)
                   for spec in self.terminal_eqs]
        return torch.cat(pieces)

    def constraints(self, z, x_current, set_point, dynamics_params):
        """Equality constraint vector c(z) (defects, pins, terminal eqs)."""
        xs, useg = self._split(z)
        x_end = vmap(self._segment_fn(dynamics_params))(xs[:-1], useg)
        defect = self._wrap_defect(x_end - xs[1:])
        lin = self._linear_eq_residuals(xs, x_current, set_point)
        return torch.cat([defect.reshape(-1), lin])

    # ---------------------------------------------------------------- closures
    def make_problem_fns(self, x_current, set_point, u_prev, dynamics_params):
        """The ``(linearize, evaluate, retract)`` closures of one solve."""
        p = self.params
        sd, N, spacing = self.state_dim, self.num_states, self.spacing
        seg_jac = self._segment_jac_fn(dynamics_params)

        def linearize(z):
            k = self._consts(z.dtype, z.device)
            xs, useg = self._split(z)
            (jx, ju), x_end = seg_jac(xs[:-1], useg)  # (S,sd,sd), (S,sd,sp)
            defect = self._wrap_defect(x_end - xs[1:])

            # Block-bidiagonal state part: rows of segment s hold +J_x at
            # state s and -I at state s+1.
            eye_sd = torch.eye(sd, dtype=z.dtype, device=z.device)
            a_x = (torch.einsum("sab,st->satb", jx, k["sel_this"])
                   - torch.einsum("ab,st->satb", eye_sd, k["sel_next"]))
            a_x = a_x.reshape((N - 1) * sd, N * sd)
            # Controls: block-diagonal over segments.
            eye_seg = torch.eye(N - 1, dtype=z.dtype, device=z.device)
            a_u = torch.einsum("sak,st->satk", ju, eye_seg).reshape(
                (N - 1) * sd, (N - 1) * spacing)
            A = torch.cat([torch.cat([a_x, a_u], dim=1), k["A_lin"]])
            c = torch.cat([defect.reshape(-1), self._linear_eq_residuals(
                xs, x_current, set_point)])
            r = self.cost_residuals(z, set_point, u_prev)
            return r, k["J_cost"], c, A

        def evaluate(z):
            r = self.cost_residuals(z, set_point, u_prev)
            c = self.constraints(z, x_current, set_point, dynamics_params)
            return r, c

        def retract(z, dz, alpha):
            k = self._consts(z.dtype, z.device)
            z2 = z + alpha * dz
            z2 = torch.where(k["angle_mask"], mod_pi(z2), z2)
            z2 = torch.where(k["pos_mask"],
                             torch.clamp(z2, -p.b_x_limit, p.b_x_limit), z2)
            return torch.where(k["u_mask"],
                               torch.clamp(z2, -p.u_limit, p.u_limit), z2)

        return linearize, evaluate, retract

    # ------------------------------------------------------------- condensed
    def make_condensed_step(self, x_current, set_point, u_prev,
                            dynamics_params):
        """The structure-exploiting damped GN step of
        ``kkt_method="condensed"`` (the reference's ``make_condensed_step``,
        ``mpc/problem.py:526-795``).

        The defect and pin rows are eliminated exactly (states are affine in
        the controls through the linearized shooting recursion), which
        leaves a K-variable problem whose matrix ``C = Hu + lam I`` holds
        only the static u-cost rows. Every terminal row, soft cost or hard
        equality, is eliminated through one small augmented Schur
        complement whose diagonal carries ``1/w^2`` for cost rows, solved
        through the QR of its stacked factor, never its Gram matrix: the
        weights never square into a factorized matrix, which keeps the
        soft-terminal-cost mode usable in f32."""
        p = self.params
        sd, sp, K = self.state_dim, self.spacing, self.window_length
        S = self.num_states - 1
        seg_jac = self._segment_jac_fn(dynamics_params)
        term_costs, term_eqs = self.terminal_costs, self.terminal_eqs
        n_t, n_tc = len(term_eqs), len(term_costs)
        n_all = n_tc + n_t
        if not np.any(self._J_cost_u):
            # C = Hu + lam I is only unconditionally SPD because the static
            # u-cost rows are nonzero.
            raise ValueError(
                "kkt_method='condensed' requires a nonzero u-cost Gram: "
                "set u_cost_weight or u_derivative_cost_weight > 0, or "
                "use kkt_method='lu'/'schur'")

        def rows(v, specs):
            return [v[spec.coord] for spec in specs]

        def at_coords(contributions, zero):
            """The (sd,) vector with each (coord, value) added at coord."""
            acc = [zero] * sd
            for coord, v in contributions:
                acc[coord] = acc[coord] + v
            return torch.stack(acc)

        def condensed_step(z, lam):
            dtype, device = z.dtype, z.device
            k = self._consts(dtype, device)
            xs, useg = self._split(z)
            (jx, ju), x_end = seg_jac(xs[:-1], useg)
            defect = self._wrap_defect(x_end - xs[1:])  # (S, sd)
            pin = self._wrap_defect(xs[0] - x_current)  # (sd,)

            # Forward sensitivity dx_s = M_s du + m_s: m_0 = -pin, M_0 = 0,
            # M/m_{s+1} = jx_s M/m_s (+ ju_s in segment s's columns,
            # + defect_s).
            M = z.new_zeros((sd, K))
            m0 = -pin
            m = m0
            for s in range(S):
                M = jx[s] @ M
                M = torch.cat([M[:, :s * sp], ju[s], M[:, (s + 1) * sp:]],
                              dim=1)
                m = jx[s] @ m + defect[s]

            # Reduced residuals and Jacobian, rows as in cost_residuals.
            r = self.cost_residuals(z, set_point, u_prev)
            zK = z.new_zeros((0, K))
            z0 = z.new_zeros((0,))
            if n_tc:
                U_costs = torch.stack(rows(M, term_costs))
                m_costs = torch.stack(rows(m, term_costs))
                term_J = torch.stack([spec.weight * M[spec.coord]
                                      for spec in term_costs])
                term_aff = k["w_costs"] * m_costs
                # Unweighted linearized terminal-cost residuals.
                b_costs = r[:n_tc] / k["w_costs"] + m_costs
            else:
                U_costs = term_J = zK
                term_aff = b_costs = z0
            J_bar = torch.cat([term_J, k["J_cost_u"]])
            aff = torch.cat([term_aff, z.new_zeros(
                (self._J_cost_u.shape[0],))])

            # Terminal equalities through M.
            R_eq = None
            if n_t:
                A_bar = torch.stack(rows(M, term_eqs))
                c_term = torch.stack([
                    self._target_diff(xs[-1], spec, set_point)
                    for spec in term_eqs])
                c_bar = c_term + torch.stack(rows(m, term_eqs))
                if p.rebase_equalities:
                    # A_bar^T = Q R: {A du = -c} = {Q^T du = -R^{-T} c},
                    # orthonormal rows for the Schur factor below.
                    qs_eq, R_eq = _mgs_qr([A_bar[j] for j in range(n_t)])
                    A_bar = torch.stack(qs_eq)
                    c_bar = torch.stack(_tri_rt_solve(R_eq, c_bar))
            else:
                A_bar, c_term, c_bar = zK, z0, z0

            # Full constraint values at z (the layout of constraints()).
            c_full = torch.cat([defect.reshape(-1), pin, c_term])

            # The augmented system
            #   [C      A_all^T] [du]   [-g_s]     C = Hu + lam I
            #   [A_all  -D     ] [mu] = [-b  ],    D = diag(1/w^2 | 0)
            C = k["Hu"] + lam * torch.eye(K, dtype=dtype, device=device)
            g_s = k["J_cost_u"].T @ r[n_tc:]
            A_all = torch.cat([U_costs, A_bar])
            b_all = torch.cat([b_costs, c_bar])
            D_diag = k["D_diag"]
            L = cholesky(C)
            sol = cho_solve(L, torch.cat([A_all.T, g_s[:, None]], dim=1))
            CiAt, Cig = sol[:, :n_all], sol[:, n_all]
            if n_all:
                # Schur solve through the stacked factor T = [L^{-1} A^T;
                # D^{1/2}]; T^T T is never formed.
                G = torch.linalg.solve_triangular(L, A_all.T, upper=False)
                T = torch.cat([G, k["sqrt_D"]])
                schur_solve = _qr_gram_factor([T[:, j]
                                               for j in range(n_all)])
                mu = schur_solve(b_all - A_all @ Cig)
                du = -(Cig + CiAt @ mu)
                # One factor-reusing refinement step.
                res_d = -g_s - (C @ du + A_all.T @ mu)
                res_c = -b_all - (A_all @ du - D_diag * mu)
                Ci_rd = cho_solve(L, res_d[:, None])[:, 0]
                e_y = schur_solve(A_all @ Ci_rd - res_c)
                du = du + Ci_rd - CiAt @ e_y
                mu = mu + e_y
            else:
                mu = z0
                du = -Cig
            nu_bar = mu[n_tc:]
            if R_eq is not None:
                # Back to the original equality multipliers: nu = R^{-1} nu~.
                nu_bar = torch.stack(_tri_r_solve(R_eq, nu_bar))

            # Expand: the forward recursion of the state step.
            dx, dxs = m0, []
            for s in range(S):
                dxs.append(dx)
                dx = (jx[s] @ dx + ju[s] @ du[s * sp:(s + 1) * sp]
                      + defect[s])
            dz = torch.cat([torch.stack(dxs + [dx]).reshape(-1), du])

            # Exact directional derivative (J^T r) . dz.
            jr_dz = torch.dot(r, J_bar @ du + aff)

            # Eliminated multipliers (defects pi_s, pin sigma) by the
            # backward adjoint pass: the merit penalty must dominate all
            # equality multipliers. The terminal-cost rows' post-step
            # gradient w^2 (U du + b) is the augmented multiplier mu.
            zero = z.new_zeros(())
            pi = at_coords(
                [(spec.coord, mu[i]) for i, spec in enumerate(term_costs)]
                + [(spec.coord, nu_bar[j])
                   for j, spec in enumerate(term_eqs)], zero)
            pi_norms = []
            for s in reversed(range(S)):
                pi_norms.append(torch.amax(torch.abs(pi)))
                pi = jx[s].T @ pi
            sigma_inf = torch.amax(torch.abs(pi))
            nu_inf = torch.maximum(
                torch.amax(torch.abs(nu_bar)) if n_t else zero,
                torch.maximum(torch.amax(torch.stack(pi_norms)), sigma_inf))

            # First-order diagnostic: the inf-norm of the full-z Lagrangian
            # gradient at the current iterate. The adjoint seeded from the
            # pre-step residuals zeroes every state row, so it reduces to
            # the control rows.
            pi = at_coords(
                [(spec.coord, spec.weight * r[i])
                 for i, spec in enumerate(term_costs)]
                + [(spec.coord, nu_bar[j])
                   for j, spec in enumerate(term_eqs)], zero)
            gu = [None] * S
            for s in reversed(range(S)):
                gu[s] = ju[s].T @ pi
                pi = jx[s].T @ pi
            g_u_full = k["J_cost_u"].T @ r[n_tc:] + torch.cat(gu)
            first_order = torch.amax(torch.abs(g_u_full))
            ok = (torch.all(torch.isfinite(dz))
                  & torch.all(torch.isfinite(mu))
                  & torch.all(torch.isfinite(torch.diagonal(L))))
            return dz, nu_inf, first_order, jr_dz, ok, r, c_full

        return condensed_step
