"""Batch-in-lanes MPC step and closed loop (counterpart of
``cartpole_tpu/mpc/lanes.py``).

The batch lives in the trailing axis of every tensor; the public functions
take and return batch-first tensors, as the reference's do. Each tick
builds the warm (or cold) start, fills the shooting states by a rollout,
runs the damped Gauss-Newton solve, evaluates the final residuals, rolls out
the predicted states, and steps the 1 kHz plant.

The solve has the reference's two bodies:

* ``fused=False`` (the default, as in the reference): a Python loop over
  the iterations of :meth:`_LanesProblem.condensed_step`, whose
  linearization is one launch of the segment-Jacobian kernel
  (``ops/pallas_kernels.py``) and whose condensation and KKT solve are
  eager torch, with all line-search trials evaluated in one folded problem
  (:meth:`_LanesProblem.tiled`);
* ``fused=True``: the whole solve as one launch of the fused iteration
  kernel (``ops/fused.py``).

Both run at full f32 matmul precision whatever the caller's global setting
(``ops/fused.py::full_f32_matmul``).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from ..models.base import SINGLE_CARTPOLE
from ..ops.fused import (full_f32_matmul, fused_solve, fused_supported,
                         make_fused_statics, params_block)
from ..ops.integrate import mod_pi, split_substeps
from ..ops.lanes import (bmv, rk4_step_lanes, rk4_step_rows, rollout_rows,
                         wrap_angles_lanes, wrap_angles_rows)
from ..ops.pallas_kernels import segment_jac_batch_last
from ..ops.solver import NLSConfig, NLSOutputs, NLSTerminationState
from ..utils.tracing import trace_scope
from .closed_loop import ClosedLoopResult, CUDAGraphTick
from .controller import MPC, MPCOutputs, MPCState
from .problem import _mgs_qr, _qr_gram_factor, _tri_r_solve, _tri_rt_solve

__all__ = ["step_lanes", "run_closed_loop_lanes", "simulator_step_lanes",
           "tick_fn_lanes"]


class _Z(NamedTuple):
    """Lanes-layout decision iterate: shooting states + controls."""

    xs: Any  #: (sd, N, B)
    u: Any  #: (K, B)


class _LanesStatics:
    """Static structure of the condensed lanes solve (reference
    ``_LanesProblem.__init__``, mpc/lanes.py:104-155): the u-cost Gram
    matrix Hu, its eigenbasis computed once in f64, the augmented-KKT
    weights, and their tensors on one device (``fused``)."""

    def __init__(self, spec, config: NLSConfig, dtype, device):
        self._Ju_cost = np.asarray(spec._J_cost_u)  # (n_u, K)
        self._Hu = self._Ju_cost.T @ self._Ju_cost  # (K, K)
        self.n_tc = len(spec.terminal_costs)
        self.n_t = len(spec.terminal_eqs)
        if not np.any(self._Ju_cost):
            raise ValueError(
                "kkt_method='condensed' requires a nonzero u-cost Gram: "
                "set u_cost_weight or u_derivative_cost_weight > 0"
            )
        e, Q = np.linalg.eigh(self._Hu.astype(np.float64))
        self._Hu_eigs = np.maximum(e, 0.0)
        self._Hu_Q = Q
        self._w_costs = np.asarray(
            [ts.weight for ts in spec.terminal_costs], np.float64
        )
        self._D_diag = np.concatenate(
            [1.0 / self._w_costs**2, np.full(self.n_t, 1.0e-12)]
        )
        self.fused = make_fused_statics(
            spec, config, self._Hu_Q, self._Hu_eigs, self._Ju_cost,
            self._D_diag, self._w_costs, dtype, device,
        )

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                   device=device)

        self.inv_w_costs = t(1.0 / self._w_costs)
        #: The line-search step sizes, made here and not in the tick: a
        #: tensor from host data cannot be made under a CUDA-graph capture.
        self.alphas = t([0.5 ** i
                         for i in range(config.max_line_search_iterations)])
        self.D_vec = t(self._D_diag)
        self.sqrtD = t(np.diag(np.sqrt(self._D_diag)))


def _lanes_statics(mpc: MPC, dtype, device) -> _LanesStatics:
    """The statics for ``(dtype, device)``, built on first use and kept on
    the MPC object."""
    key = ("lanes", dtype, device)
    if key not in mpc.statics_cache:
        mpc.statics_cache[key] = _LanesStatics(
            mpc.spec, mpc.nls_config, dtype, device)
    return mpc.statics_cache[key]


def _fold_lanes(arr, reps: int, batch: int):
    """Trial-major lane fold (index ``a * batch + b``): broadcast the
    trailing instance axis to ``reps`` copies and flatten. The single
    definition of the fold order: the tiled line-search problem and the
    per-iteration trial folding must agree on it, or trial merits get
    attributed to the wrong instances."""
    lead = tuple(arr.shape[:-1])
    return arr[..., None, :].expand(lead + (reps, batch)).reshape(
        lead + (reps * batch,))


def _param_folder(dynamics_params, batch: int):
    """Return ``fold(reps)``: dynamics params broadcastable against a
    ``(..., reps * batch)`` folded lane axis. 0-d fields pass through;
    per-instance ``(B,)`` fields are tiled across the fold."""

    def fold(reps: int):
        if reps == 1:
            return dynamics_params

        def one(leaf):
            leaf = torch.as_tensor(leaf)
            if leaf.ndim == 0:
                return leaf
            assert tuple(leaf.shape) == (batch,), leaf.shape
            return _fold_lanes(leaf, reps, batch)

        return type(dynamics_params)(**{
            k: one(v) for k, v in dynamics_params.as_dict().items()})

    return fold


class _LanesProblem:
    """Per-solve data over the lanes iterate: ``x_current (sd, B)``,
    ``set_point``/``u_prev`` ``(B,)``, dynamics params (fields 0-d or
    ``(B,)``), and the shared statics."""

    def __init__(self, spec, x_current, set_point, u_prev, dynamics_params,
                 statics: _LanesStatics):
        self.spec = spec
        self.x_current = x_current.contiguous()
        self.set_point = set_point.contiguous()
        self.u_prev = u_prev.contiguous()
        self.B = x_current.shape[1]
        self.dynamics_params = dynamics_params
        self.statics = statics
        self.sd, self.sp = spec.state_dim, spec.spacing
        self.K = spec.window_length
        self.S = spec.num_states - 1

    def tiled(self, A: int) -> "_LanesProblem":
        """A copy whose instance axis is ``A`` stacked copies of this
        problem's (fold order ``a * B + b``): all ``A`` line-search trials
        evaluate in ONE folded rollout."""

        def rep(arr):
            return _fold_lanes(arr, A, self.B)

        dp = _param_folder(self.dynamics_params, self.B)(A)
        return _LanesProblem(self.spec, rep(self.x_current),
                             rep(self.set_point), rep(self.u_prev), dp,
                             self.statics)

    # ------------------------------------------------------------ residuals
    def cost_residuals(self, Z: _Z):
        """(n_res, B) — row order matches ``MPCProblemSpec.cost_residuals``."""
        spec, p = self.spec, self.spec.params
        xN = Z.xs[:, -1, :]  # (sd, B)
        pieces = []
        for ts in spec.terminal_costs:
            target = self.set_point if ts.is_setpoint else ts.target
            diff = xN[ts.coord] - target
            if ts.is_angle:
                diff = mod_pi(diff)
            pieces.append((ts.weight * diff)[None])
        u = Z.u
        if p.u_derivative_cost_weight > 0.0:
            w = p.u_derivative_cost_weight
            pieces.append(w * (u[:-1] - u[1:]))
            pieces.append((w * (u[0] - self.u_prev))[None])
        if p.u_cost_weight > 0.0:
            pieces.append(p.u_cost_weight * u)
        if not pieces:
            return Z.u.new_zeros((0, self.B))
        return torch.cat(pieces, dim=0)

    def _terminal_eq_residuals(self, Z: _Z):
        xN = Z.xs[:, -1, :]
        vals = []
        for ts in self.spec.terminal_eqs:
            target = self.set_point if ts.is_setpoint else ts.target
            diff = xN[ts.coord] - target
            if ts.is_angle:
                diff = mod_pi(diff)
            vals.append(diff)
        if not vals:
            return Z.u.new_zeros((0, self.B))
        return torch.stack(vals)

    # ------------------------------------------------------------- segments
    def _fold_segments(self, Z: _Z):
        """Contiguous ``(x_start (sd, S*B), useg (sp, S*B))``, column
        ``s * B + b``: the kernel's batch-last columns."""
        sd, S, sp, B = self.sd, self.S, self.sp, self.B
        x_start = Z.xs[:, :-1, :].reshape(sd, S * B).contiguous()
        useg = Z.u.reshape(S, sp, B).transpose(0, 1).reshape(sp, S * B)
        return x_start, useg.contiguous()

    def _fold_segment_rows(self, Z: _Z):
        """Per-coordinate ``(S, B)`` segment start states and the segment
        controls ``(sp, S, B)``. The reference folds segments into one
        ``S*B`` lane axis; broadcasting over a ``(S, B)`` shape is the same
        arithmetic."""
        sd, S, sp, B = self.sd, self.S, self.sp, self.B
        x_rows = tuple(Z.xs[i, :-1, :] for i in range(sd))
        useg = Z.u.reshape(S, sp, B).transpose(0, 1)
        return x_rows, useg

    def _constraints(self, Z: _Z):
        """Full equality-constraint values, (n_eq, B); row order matches
        ``MPCProblemSpec.constraints`` (defects s-major, pins, terminal)."""
        spec = self.spec
        sd, S = self.sd, self.S
        model, p = spec.model, spec.params
        angle = model.angle_indices
        x_rows, useg = self._fold_segment_rows(Z)
        dp = self.dynamics_params
        xe_rows = rollout_rows(
            lambda xr, u_: model.dynamics_core(dp, xr, u_), x_rows, useg,
            p.control_dt, angle,
        )
        defect_rows = []
        for i in range(sd):
            d = xe_rows[i] - Z.xs[i, 1:, :]
            defect_rows.append(mod_pi(d) if i in angle else d)
        defect = torch.stack(
            [defect_rows[i][s] for s in range(S) for i in range(sd)]
        )
        pin = torch.stack(wrap_angles_rows(
            tuple(Z.xs[i, 0, :] - self.x_current[i] for i in range(sd)),
            angle,
        ))
        c_term = self._terminal_eq_residuals(Z)
        return torch.cat([defect, pin, c_term], dim=0)

    def evaluate(self, Z: _Z):
        return self.cost_residuals(Z), self._constraints(Z)

    def retract(self, Z: _Z, dZ: _Z, alpha):
        """Clamp/wrap retraction (``optimization.cc:309-329``); ``alpha``
        is a scalar or per-instance ``(B,)``."""
        spec, p = self.spec, self.spec.params
        xs = Z.xs + alpha * dZ.xs
        u = torch.clamp(Z.u + alpha * dZ.u, -p.u_limit, p.u_limit)
        rows = list(wrap_angles_rows(tuple(xs), spec.model.angle_indices))
        rows[0] = torch.clamp(rows[0], -p.b_x_limit, p.b_x_limit)
        return _Z(xs=torch.stack(rows), u=u)

    # ------------------------------------------------------------ condensed
    def condensed_step(self, Z: _Z, lam):
        """Batch-last condensed damped-GN step, ``lam`` per-instance
        ``(B,)`` (reference ``_LanesProblem.condensed_step``,
        mpc/lanes.py:293-540, which has the derivation).

        Returns ``(dZ, nu_inf, first_order, jr_dz, ok, r, c_full)`` with
        per-instance ``(B,)`` scalars.
        """
        spec, st = self.spec, self.statics
        sd, S, sp, K, B = self.sd, self.S, self.sp, self.K, self.B
        model, p = spec.model, spec.params
        angle = model.angle_indices
        dtype, dev = Z.u.dtype, Z.u.device
        term_costs, term_eqs = spec.terminal_costs, spec.terminal_eqs
        n_tc, n_t = st.n_tc, st.n_t
        fz = st.fused

        # Linearization: one kernel launch over the S*B folded columns.
        x_start, useg = self._fold_segments(Z)
        params_cols = _fold_lanes(
            params_block(self.dynamics_params, B, dtype, dev), S, B)
        x_end, Jx, Ju = segment_jac_batch_last(
            params_cols, x_start, useg, p.control_dt, angle, model)
        x_end = x_end.reshape(sd, S, B)
        Jx = Jx.reshape(sd, sd, S, B)
        Ju = Ju.reshape(sd, sp, S, B)
        defect = wrap_angles_lanes(x_end - Z.xs[:, 1:, :], angle)
        pin = wrap_angles_lanes(Z.xs[:, 0, :] - self.x_current, angle)

        # Forward condensation: dx_s = M_s du + m_s.
        M = Z.u.new_zeros((sd, K, B))
        m = -pin
        for s in range(S):
            jx_s = Jx[:, :, s, :]
            M = torch.sum(jx_s[:, :, None, :] * M[None, :, :, :], dim=1)
            M[:, s * sp:(s + 1) * sp, :] = Ju[:, :, s, :]
            m = bmv(jx_s, m) + defect[:, s, :]

        r = self.cost_residuals(Z)
        r_term = r[:n_tc]
        r_u = r[n_tc:]
        if n_tc:
            term_J = torch.stack(
                [ts.weight * M[ts.coord] for ts in term_costs])
            term_aff = torch.stack(
                [ts.weight * m[ts.coord] for ts in term_costs])
            U_costs = torch.stack([M[ts.coord] for ts in term_costs])
            b_costs = (r_term + term_aff) * st.inv_w_costs[:, None]
        else:
            term_J = U_costs = Z.u.new_zeros((0, K, B))
            term_aff = b_costs = Z.u.new_zeros((0, B))

        g_s = fz.JuT @ r_u  # (K, B)

        c_term = self._terminal_eq_residuals(Z)
        if n_t:
            A_eq = torch.stack([M[ts.coord] for ts in term_eqs])
            c_bar = c_term + torch.stack([m[ts.coord] for ts in term_eqs])
        else:
            A_eq = Z.u.new_zeros((0, K, B))
            c_bar = Z.u.new_zeros((0, B))

        R_eq = None
        if n_t and p.rebase_equalities:
            # Constraint-space re-basing: per-instance QR of A_eq^T makes
            # the equality rows orthonormal (same constraint set).
            qs_eq, R_eq = _mgs_qr(list(A_eq))
            A_eq = torch.stack(qs_eq)
            c_bar = torch.stack(_tri_rt_solve(R_eq, c_bar))

        # Augmented KKT: C = Hu + lam I in the static eigenbasis; every
        # terminal row eliminated through the stacked Schur factor
        # T = [C^{-1/2} A^T; D^{1/2}], whose Gram matrix is never formed.
        n_all = n_tc + n_t
        A_all = torch.cat([U_costs, A_eq], dim=0)  # (n_all, K, B)
        b_all = torch.cat([b_costs, c_bar], dim=0)  # (n_all, B)
        Q, QT, eigs = fz.Q, fz.QT, fz.eigs  # eigs (K, 1)
        d_inv = 1.0 / (eigs + lam[None, :])  # (K, B)

        def eig_rescale(diag):
            """Apply ``Q diag Q^T`` to stacked rows ``X (R, K, B)``."""

            def apply(X):
                n = X.shape[0]
                X2 = X.transpose(0, 1).reshape(K, n * B)
                Y = (QT @ X2).reshape(K, n, B) * diag[:, None, :]
                Zr = (Q @ Y.reshape(K, n * B)).reshape(K, n, B)
                return Zr.transpose(0, 1)

            return apply

        c_solve = eig_rescale(d_inv)

        def c_mul(x):
            """(Hu + lam I) x for x (K, B), used by the refinement."""
            return Q @ ((QT @ x) * (eigs + lam[None, :]))

        sol = c_solve(torch.cat([A_all, g_s[None]], dim=0))
        CiA, Cig = sol[:n_all], sol[n_all]
        if n_all:
            G = eig_rescale(torch.sqrt(d_inv))(A_all)  # (n_all, K, B)
            T = torch.cat([G.transpose(0, 1),
                           st.sqrtD[:, :, None].expand(n_all, n_all, B)])
            schur_solve = _qr_gram_factor([T[:, j] for j in range(n_all)])
            A_Cig = torch.sum(A_all * Cig[None], dim=1)
            mu = schur_solve(b_all - A_Cig)  # (n_all, B)
            du = -(Cig + torch.sum(CiA * mu[:, None, :], dim=0))
            # One refinement step on the augmented system.
            At_mu = torch.sum(A_all * mu[:, None, :], dim=0)
            res_d = -g_s - (c_mul(du) + At_mu)
            res_c = -b_all - (torch.sum(A_all * du[None], dim=1)
                              - st.D_vec[:, None] * mu)
            Ci_rd = c_solve(res_d[None])[0]
            e_y = schur_solve(torch.sum(A_all * Ci_rd[None], dim=1) - res_c)
            du = du + Ci_rd - torch.sum(CiA * e_y[:, None, :], dim=0)
            mu = mu + e_y
        else:
            mu = Z.u.new_zeros((0, B))
            du = -Cig
        mu_c, nu = mu[:n_tc], mu[n_tc:]
        if R_eq is not None:
            # Back to the original equality multipliers (nu = R^{-1} nu~).
            nu = torch.stack(_tri_r_solve(R_eq, nu))

        # Expand the state step by the forward recursion.
        dx = -pin
        dxs = [dx]
        for s in range(S):
            du_s = du[s * sp:(s + 1) * sp]  # (sp, B)
            dx = (bmv(Jx[:, :, s, :], dx)
                  + torch.sum(Ju[:, :, s, :] * du_s[None], dim=1)
                  + defect[:, s, :])
            dxs.append(dx)
        dZ = _Z(xs=torch.stack(dxs, dim=1), u=du)

        # Exact directional derivative (J^T r) . dz.
        Jdu_term = torch.sum(term_J * du[None], dim=1)  # (n_tc, B)
        Jdu_u = fz.Juc @ du  # (n_u, B)
        jr_dz = (torch.sum(r_term * (Jdu_term + term_aff), dim=0)
                 + torch.sum(r_u * Jdu_u, dim=0))

        # Post-step multiplier estimates for the merit ramp: the terminal
        # cost rows' post-step gradient is the augmented multiplier mu_c.
        gN = Z.u.new_zeros((sd, B))
        for i, ts in enumerate(term_costs):
            gN[ts.coord] += mu_c[i]
        for j, ts in enumerate(term_eqs):
            gN[ts.coord] += nu[j]
        pi = gN
        pi_max = Z.u.new_zeros((B,))
        for s in reversed(range(S)):
            pi_max = torch.maximum(pi_max, torch.amax(torch.abs(pi), dim=0))
            pi = torch.sum(Jx[:, :, s, :] * pi[:, None, :], dim=0)
        sigma_inf = torch.amax(torch.abs(pi), dim=0)
        nu_abs = (torch.amax(torch.abs(nu), dim=0) if n_t
                  else Z.u.new_zeros((B,)))
        nu_inf = torch.maximum(nu_abs, torch.maximum(pi_max, sigma_inf))

        # First-order diagnostic: full-z Lagrangian gradient inf-norm with
        # the eliminated multipliers from the pre-step residuals.
        gN_pre = Z.u.new_zeros((sd, B))
        for i, ts in enumerate(term_costs):
            gN_pre[ts.coord] += ts.weight * r_term[i]
        for j, ts in enumerate(term_eqs):
            gN_pre[ts.coord] += nu[j]
        pi = gN_pre
        gu = [None] * S
        for s in reversed(range(S)):
            gu[s] = torch.sum(Ju[:, :, s, :] * pi[:, None, :], dim=0)
            pi = torch.sum(Jx[:, :, s, :] * pi[:, None, :], dim=0)
        g_u_full = fz.JuT @ r_u + torch.cat(gu, dim=0)
        first_order = torch.amax(torch.abs(g_u_full), dim=0)

        ok = (torch.isfinite(dZ.xs).flatten(0, 1).all(0)
              & torch.isfinite(du).all(0))
        if n_all:
            ok = ok & torch.isfinite(mu).all(0)

        c_full = torch.cat([defect.transpose(0, 1).reshape(S * sd, B), pin,
                            c_term], dim=0)
        return dZ, nu_inf, first_order, jr_dz, ok, r, c_full


def _init_carry(Z0: _Z, config: NLSConfig):
    """The solve's initial carry: lambda0, mu0, merit +inf, not done,
    MAX_ITERATIONS, first-order +inf."""
    B = Z0.u.shape[1]
    like = Z0.u.new_empty((B,))
    return (
        Z0.xs, Z0.u,
        torch.full_like(like, config.lambda_initial),
        torch.full_like(like, config.equality_penalty_initial),
        torch.full_like(like, math.inf),
        torch.zeros((B,), dtype=torch.int32, device=like.device),
        torch.full((B,), NLSTerminationState.MAX_ITERATIONS,
                   dtype=torch.int32, device=like.device),
        torch.full_like(like, math.inf),
    )


def _iterate_xla(problem: _LanesProblem, Z0: _Z, config: NLSConfig):
    """The reference's non-fused iteration body (mpc/lanes.py:583-696) as a
    Python loop over ``max_iterations``: condensed step, L1 merit with its
    penalty ramp, all line-search trials in ONE folded evaluation of the
    tiled problem, acceptance, LM damping, termination and the freeze of
    finished instances. Returns ``(Z, lam, term, first_order, traces)``."""
    dtype = Z0.u.dtype
    B = problem.B
    n_ls = config.max_line_search_iterations
    alphas = problem.statics.alphas
    trials = problem.tiled(n_ls)
    alpha_fold = alphas[:, None].expand(n_ls, B).reshape(n_ls * B)
    eps = torch.finfo(dtype).eps

    def rep(arr):
        return _fold_lanes(arr, n_ls, B)  # same fold as problem.tiled()

    xs, u, lam, mu, merit_prev, done, term, fo = _init_carry(Z0, config)
    Z, done = _Z(xs=xs, u=u), done != 0
    rows = []
    T_ = NLSTerminationState
    for _ in range(config.max_iterations):
        dZ, nu_inf, first_order, jr_dz, qp_ok, r, c = \
            problem.condensed_step(Z, lam)
        cost = 0.5 * torch.sum(r * r, dim=0)
        viol1 = torch.sum(torch.abs(c), dim=0)
        dZ = _Z(xs=torch.where(qp_ok, dZ.xs, 0.0),
                u=torch.where(qp_ok, dZ.u, 0.0))

        mu_new = torch.maximum(mu, config.penalty_multiplier_margin * nu_inf)
        phi0 = cost + mu_new * viol1
        dphi = jr_dz - mu_new * viol1

        Za = trials.retract(_Z(xs=rep(Z.xs), u=rep(Z.u)),
                            _Z(xs=rep(dZ.xs), u=rep(dZ.u)), alpha_fold)
        ra, ca = trials.evaluate(Za)
        cost_a = 0.5 * torch.sum(ra * ra, dim=0).reshape(n_ls, B)
        viol_a = torch.sum(torch.abs(ca), dim=0).reshape(n_ls, B)
        phi_trials = cost_a + mu_new[None] * viol_a  # (A, B)
        phi_trials = torch.where(torch.isfinite(phi_trials), phi_trials,
                                 math.inf)
        # Few-ulp merit slack (NLSConfig.merit_slack_ulps).
        slack = config.merit_slack_ulps * eps * torch.abs(phi0)
        accepts = phi_trials <= (phi0 + config.armijo_c1
                                 * (alphas[:, None] * dphi) + slack)
        any_accept = torch.any(accepts, dim=0) & qp_ok
        first_idx = torch.argmax(accepts.to(torch.int8), dim=0)  # (B,)
        alpha_used = torch.where(any_accept, alphas[first_idx], 0.0)
        # Re-retract at the accepted alpha: the retraction is elementwise,
        # so this reproduces the accepted trial exactly.
        Z_acc = problem.retract(Z, dZ, alpha_used)
        phi_new = torch.where(
            any_accept, torch.gather(phi_trials, 0, first_idx[None])[0], phi0)

        lam_next = torch.where(
            any_accept, lam * config.lambda_decrease,
            torch.clamp_min(lam * config.lambda_increase,
                            config.lambda_failure_floor))
        Z_next = _Z(xs=torch.where(any_accept, Z_acc.xs, Z.xs),
                    u=torch.where(any_accept, Z_acc.u, Z.u))

        # merit_prev is +inf on iteration 0: keep the inf out of the
        # division.
        prev_ok = torch.isfinite(merit_prev)
        mp = torch.where(prev_ok, merit_prev, 0.0)
        rel_change = torch.where(
            prev_ok,
            torch.abs(mp - phi_new) / torch.clamp_min(torch.abs(mp), 1.0e-30),
            math.inf)
        conv_rel = any_accept & (rel_change < config.relative_exit_tol)
        conv_first = first_order < config.absolute_first_derivative_tol
        fail_lambda = lam_next > config.lambda_max
        fail_qp = ~qp_ok
        new_term = torch.where(
            conv_first, T_.SATISFIED_FIRST_ORDER_TOL,
            torch.where(conv_rel, T_.SATISFIED_RELATIVE_TOL,
                        torch.where(fail_qp, T_.QP_INDEFINITE,
                                    torch.where(fail_lambda, T_.MAX_LAMBDA,
                                                T_.MAX_ITERATIONS))),
        ).to(torch.int32)
        now_done = conv_rel | conv_first | fail_lambda | fail_qp

        rows.append((
            torch.where(done, math.nan, cost),
            torch.where(done, math.nan, torch.amax(torch.abs(c), dim=0)),
            torch.where(done, math.nan, lam),
            torch.where(done, 0.0, alpha_used),
            torch.where(done, math.nan, first_order),
            ~done,
        ))
        Z = _Z(xs=torch.where(done, Z.xs, Z_next.xs),
               u=torch.where(done, Z.u, Z_next.u))
        lam = torch.where(done, lam, lam_next)
        mu = torch.where(done, mu, mu_new)
        merit_prev = torch.where(done, merit_prev, phi_new)
        term = torch.where(done, term, new_term)
        fo = torch.where(done, fo, first_order)
        done = done | now_done
    traces = tuple(torch.stack([row[k] for row in rows]) for k in range(6))
    return Z, lam, term, fo, traces


_FUSED_UNSUPPORTED = (
    "fused=True but this configuration is not covered by the fused kernel "
    "(needs generated-core dynamics, dynamics params scalar or per-instance "
    "(B,), rebase_equalities off)"
)


def _solve_lanes(problem: _LanesProblem, Z0: _Z, config: NLSConfig,
                 fused: bool = False):
    """The lanes damped-GN solve at full f32 matmul precision, whatever the
    caller's global setting (the reference solves under
    ``jax.default_matmul_precision("float32")``, mpc/lanes.py:552); the
    caller's setting is restored on exit."""
    with full_f32_matmul():
        return _solve_lanes_impl(problem, Z0, config, fused)


def _solve_lanes_impl(problem: _LanesProblem, Z0: _Z, config: NLSConfig,
                      fused: bool = False):
    """The fixed-trip damped-GN solve, then the final residual evaluation.
    ``fused=True`` runs one ``fused_solve`` over all ``max_iterations`` (the
    reference's single-launch mode); ``fused=False`` the iteration loop of
    :func:`_iterate_xla`."""
    B = problem.B
    with trace_scope("tick.solve"):
        if fused:
            if not fused_supported(problem, config):
                raise ValueError(_FUSED_UNSUPPORTED)
            (xs, u, lam, _, _, _, term, first_order), traces = fused_solve(
                problem.statics.fused, problem.dynamics_params,
                problem.x_current, problem.set_point, problem.u_prev,
                _init_carry(Z0, config), config.max_iterations,
            )
            Z = _Z(xs=xs, u=u)
        else:
            Z, lam, term, first_order, traces = _iterate_xla(problem, Z0,
                                                             config)
    iter_cost, iter_viol, iter_lambda, iter_alpha, iter_first, applied = traces

    with trace_scope("tick.evaluate"):
        r, c = problem.evaluate(Z)
        cost = 0.5 * torch.sum(r * r, dim=0)
        viol = (torch.amax(torch.abs(c), dim=0) if c.shape[0]
                else Z.u.new_zeros((B,)))
        outputs = NLSOutputs(
            termination_state=term,
            n_iterations=torch.sum(applied, dim=0, dtype=torch.int32),
            cost=cost,
            constraint_violation=viol,
            first_order_norm=first_order,
            lambda_final=lam,
            # (iters, B) -> (B, iters): the batch-first layout of the
            # reference.
            iter_cost=iter_cost.T,
            iter_violation=iter_viol.T,
            iter_lambda=iter_lambda.T,
            iter_step_size=iter_alpha.T,
            iter_first_order=iter_first.T,
        )
    return Z, outputs


def _prepare(mpc: MPC, state: MPCState, x_current, dynamics_params,
             b_x_set_point=0.0):
    """Warm/cold start and shooting fill: ``(problem, Z0)`` of one tick."""
    spec = mpc.spec
    B, sd = x_current.shape
    dtype, device = x_current.dtype, x_current.device
    K, sp = spec.window_length, spec.spacing
    xc = x_current.T.contiguous()  # (sd, B)
    set_point = torch.broadcast_to(
        torch.as_tensor(b_x_set_point, dtype=dtype, device=device), (B,))

    # Warm/cold start (optimization.cc:50-67), elementwise over instances.
    u_prev = state.previous_solution[:, spec.u_start:].to(dtype).T  # (K, B)
    u_warm = torch.cat([u_prev[1:], u_prev[-1:]])
    k = torch.arange(K, dtype=dtype, device=device)
    u_cold = (mpc.params.u_guess_sinusoid_amplitude
              * torch.sin(k / K * (2.0 * math.pi)))[:, None]
    warm = state.warm  # (B,) bool
    u_guess = torch.where(warm, u_warm, u_cold)
    u_prev_cont = torch.where(warm, u_prev[0], torch.zeros_like(u_prev[0]))

    # Rows rollout of the guess fills the shooting states.
    core = mpc.model.dynamics_core
    _, steps = rollout_rows(
        lambda xr, u_: core(dynamics_params, xr, u_), tuple(xc), u_guess,
        mpc.params.control_dt, mpc.model.angle_indices, stack_states=True,
    )  # row tuple of (K, B)
    shoot = torch.stack([
        torch.cat([xc[i][None], steps[i][sp - 1::sp]], dim=0)
        for i in range(sd)
    ])  # (sd, N, B)
    statics = _lanes_statics(mpc, dtype, device)
    problem = _LanesProblem(spec, xc, set_point, u_prev_cont,
                            dynamics_params, statics)
    return problem, _Z(xs=shoot, u=u_guess.contiguous())


# ---------------------------------------------------------------------- step
def _solved(mpc: MPC, state: MPCState, x_current, dynamics_params,
            b_x_set_point, fused: bool):
    """The first three phases of a step, each a span: the warm or cold
    start and the guess rollout (``tick.prepare``), the solve
    (``tick.solve``) and the final evaluation (``tick.evaluate``). Returns
    ``(problem, Z0, Z, solver outputs)``."""
    if mpc.params.kkt_method != "condensed":
        raise ValueError(
            "step_lanes implements the condensed KKT path only; got "
            f"kkt_method={mpc.params.kkt_method!r}"
        )
    with trace_scope("tick.prepare"):
        problem, Z0 = _prepare(mpc, state, x_current, dynamics_params,
                               b_x_set_point)
    Z, solver_outputs = _solve_lanes(problem, Z0, mpc.nls_config, fused)
    return problem, Z0, Z, solver_outputs


def _step_outputs(mpc: MPC, x_current, dynamics_params, problem, Z0, Z,
                  solver_outputs):
    """The step's outputs from :func:`_solved`'s: the predicted rollout
    and the packed solution, ``(MPCOutputs, MPCState)``."""
    spec = mpc.spec
    B, sd = x_current.shape
    N = spec.num_states
    core = mpc.model.dynamics_core
    _, steps2 = rollout_rows(
        lambda xr, u_: core(dynamics_params, xr, u_),
        tuple(problem.x_current), Z.u, mpc.params.control_dt,
        mpc.model.angle_indices, stack_states=True,
    )
    predicted = torch.stack(steps2)  # (sd, K, B)

    def pack(zt: _Z):
        """Lanes iterate -> batch-first packed decision vector (B, dim)."""
        xs_b = zt.xs.permute(2, 1, 0).reshape(B, N * sd)
        return torch.cat([xs_b, zt.u.T], dim=1)

    z_sol = pack(Z)
    outputs = MPCOutputs(
        initial_state=x_current,
        previous_solution=pack(Z0),
        solver=solver_outputs,
        u=Z.u.T,  # (B, K)
        predicted_states=predicted.permute(2, 1, 0),  # (B, K, sd)
        solution=z_sol,
    )
    new_state = MPCState(
        previous_solution=z_sol,
        warm=torch.ones((B,), dtype=torch.bool, device=x_current.device),
    )
    return outputs, new_state


def step_lanes(mpc: MPC, state: MPCState, x_current, dynamics_params,
               b_x_set_point=0.0, fused: bool = False):
    """Batched MPC step in the lanes layout, the counterpart of the
    reference's ``step_lanes``: ``state`` fields and ``x_current`` ``(B,
    sd)`` carry a LEADING batch axis; internally the batch is the trailing
    axis. Requires ``kkt_method="condensed"``. ``fused`` picks the solve
    body (module docstring); ``fused=True`` raises ``ValueError`` where the
    fused kernel does not cover the configuration, as the reference does.
    With tracing on, its phases are spans ``tick.prepare``, ``tick.solve``,
    ``tick.evaluate`` and ``tick.predict`` (the predicted rollout and the
    packing)."""
    solved = _solved(mpc, state, x_current, dynamics_params, b_x_set_point,
                     fused)
    with trace_scope("tick.predict"):
        return _step_outputs(mpc, x_current, dynamics_params, *solved)


# ----------------------------------------------------------------- simulator
def simulator_step_lanes(dynamics_params, x, dt: float, u, f_base=None,
                         f_mass=None, model=SINGLE_CARTPOLE,
                         internal_dt: float = 1.0e-3):
    """Plant substep integration, batch-last: ``x`` (sd, B), ``u`` (B,),
    external forces ``f_base``/``f_mass`` ``(2, B)`` or ``(2,)`` at the base
    and at the first (for the single model, the only) link mass. Same 1 kHz
    fixed-substep arithmetic as the reference (``simulator.cc:17-23``): the
    rows path of the model's generated dynamics without forces, its packed
    dynamics (``model.dynamics``) with them."""
    n_full, remainder = split_substeps(dt, internal_dt)
    if f_base is None and f_mass is None:
        rows = tuple(x[i] for i in range(x.shape[0]))

        def fr(xr, u_):
            return model.dynamics_core(dynamics_params, xr, u_)

        if n_full:
            rows = rollout_rows(fr, rows,
                                u.expand((n_full,) + tuple(u.shape)),
                                internal_dt, model.angle_indices)
        if remainder:
            rows = rk4_step_rows(fr, rows, u, remainder)
            rows = wrap_angles_rows(rows, model.angle_indices)
        return torch.stack(rows)

    def f(x_, u_):
        return model.dynamics(dynamics_params, x_, u_, f_base, f_mass)

    for h in [internal_dt] * n_full + ([remainder] if remainder else []):
        x = wrap_angles_lanes(rk4_step_lanes(f, x, u, h), model.angle_indices)
    return x


# ---------------------------------------------------------------- closed loop
def tick_fn_lanes(mpc: MPC, dynamics_params, set_point,
                  auto_reset: bool = True, fused: bool = False):
    """One tick of :func:`run_closed_loop_lanes` as a function of tensors
    only, ``(x (sd, B), previous_solution (B, dim), warm (B,)[, dist (2, 2,
    B)]) -> (x_next (sd, B), previous_solution, warm, x.T, u0, terminal
    prediction (B, sd), termination codes, constraint violations,
    iterations)``: the unit the loop repeats and ``CUDAGraphTick``
    captures. ``set_point`` is ``(B,)``; ``dist[0]`` and ``dist[1]`` are
    the forces at the base and at the first link mass. With tracing on, the
    tick is five spans in turn: ``tick.prepare``, ``tick.solve``,
    ``tick.evaluate``, ``tick.predict`` (the predicted rollout, the
    packing, the failure mask and reset) and ``tick.plant``."""

    def tick(x, previous_solution, warm, dist=None):
        solved = _solved(mpc, MPCState(previous_solution, warm), x.T,
                         dynamics_params, set_point, fused)
        with trace_scope("tick.predict"):
            outputs, st = _step_outputs(mpc, x.T, dynamics_params, *solved)
            u0 = outputs.u[:, 0]  # (B,)
            if auto_reset:
                failed = mpc.failure_mask(outputs)
                st = mpc.reset_where(st, failed)
                u0 = torch.where(failed, torch.zeros_like(u0), u0)
        with trace_scope("tick.plant"):
            x_next = simulator_step_lanes(
                dynamics_params, x, mpc.params.control_dt, u0,
                None if dist is None else dist[0],
                None if dist is None else dist[1], model=mpc.model,
            )
        return (x_next, st.previous_solution, st.warm, x.T, u0,
                outputs.predicted_states[:, -1, :],
                outputs.solver.termination_state,
                outputs.solver.constraint_violation,
                outputs.solver.n_iterations)

    return tick


def _replays(x0) -> bool:
    """Whether the loop replays a capture of its tick: on the card."""
    return x0.is_cuda


def run_closed_loop_lanes(mpc: MPC, x0, dynamics_params, num_steps: int,
                          set_point=0.0, mpc_state: MPCState | None = None,
                          auto_reset: bool = True, disturbances=None,
                          fused: bool = False) -> ClosedLoopResult:
    """Counterpart of the reference's ``run_closed_loop_lanes``: ``x0`` is
    ``(B, sd)``, results carry a leading batch axis. Each tick is a lanes
    MPC solve plus the lanes plant substeps; with ``auto_reset`` a failed
    solve discards its warm start and applies ``u = 0`` for the tick.

    ``disturbances``: optional ``(B, num_steps, 2, 2)`` external plant
    forces (``[:, :, 0]`` at the base, ``[:, :, 1]`` at the first link
    mass, each ``(fx, fy)``), invisible to the planner, for every model.

    On the card the first tick runs eagerly and the second is captured in
    a CUDA graph (``CUDAGraphTick``, whose eager warm-up gives the second
    tick's outputs); every later tick replays that graph, its carry and
    its slice of ``disturbances`` copied in: the counterpart of the
    reference's one compiled ``lax.scan``. The graph and its memory go
    when the call returns. On the CPU every tick runs eagerly.

    With tracing on (``utils/tracing.py``) the call is a span ``lanes.call``
    (args ``B``, ``ticks``, ``fused``) holding a ``lanes.eager_tick`` for
    each eagerly run tick, the graph's ``graph.*`` spans and a
    ``lanes.replay`` for each replayed tick (copy-in, replay, clones); the
    graph times the tick's phases on the card (``CUDAGraphTick.phase_ms``).
    """
    B, sd = x0.shape
    dtype, device = x0.dtype, x0.device
    if mpc_state is None:
        mpc_state = MPCState(
            previous_solution=torch.zeros((B, mpc.spec.dim), dtype=dtype,
                                          device=device),
            warm=torch.zeros((B,), dtype=torch.bool, device=device),
        )
    set_point = torch.broadcast_to(
        torch.as_tensor(set_point, dtype=dtype, device=device), (B,))
    if disturbances is not None:
        disturbances = torch.as_tensor(disturbances, dtype=dtype,
                                       device=device)
        if tuple(disturbances.shape) != (B, num_steps, 2, 2):
            raise ValueError(
                f"disturbances must be (B, num_steps, 2, 2) = "
                f"{(B, num_steps, 2, 2)}, got {tuple(disturbances.shape)}")
        disturbances = disturbances.permute(1, 2, 3, 0)  # (T, 2, 2, B)

    def dist(t):
        return () if disturbances is None else (disturbances[t],)

    tick = tick_fn_lanes(mpc, dynamics_params, set_point, auto_reset, fused)
    carry = (x0.T, mpc_state.previous_solution, mpc_state.warm)
    graph = None
    ticks = []
    with trace_scope("lanes.call", call=True, B=B, ticks=num_steps,
                     fused=fused):
        for t in range(num_steps):
            args = carry + dist(t)
            if graph is not None:
                with trace_scope("lanes.replay", tick=t):
                    out = graph(*args)
            elif t == 1 and _replays(x0):
                graph = CUDAGraphTick(tick, args)
                out = graph.warmup_outputs
            else:
                with trace_scope("lanes.eager_tick", tick=t):
                    out = tick(*args)
            ticks.append(out[3:])
            carry = out[:3]
        states, controls, term_pred, term_codes, violations, iters = (
            torch.stack(col, dim=1) for col in zip(*ticks)
        )
    return ClosedLoopResult(
        final_state=carry[0].T,
        final_mpc_state=MPCState(carry[1], carry[2]),
        states=states,
        controls=controls,
        terminal_predictions=term_pred,
        termination_states=term_codes,
        constraint_violations=violations,
        solver_iterations=iters,
    )
