"""Batch-in-lanes MPC tick in plain PyTorch: a frozen copy of the port's
``cartpole_tpu_torch/mpc/lanes.py`` at the commit that added the benchmark,
with the solve's kernel replaced by its plain version (``ops/fused.py``)
and the CUDA-graph loop left out.

The batch lives in the trailing axis of every tensor; the public functions
take and return batch-first tensors. Each tick builds the warm (or cold)
start, fills the shooting states by a rollout, runs the damped
Gauss-Newton solve, evaluates the final residuals, rolls out the predicted
states, masks failed solves, and steps the 1 kHz plant.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from ..models.base import SINGLE_CARTPOLE
from ..ops.fused import full_f32_matmul, fused_solve, make_fused_statics
from ..ops.integrate import mod_pi, split_substeps
from ..ops.lanes import (rk4_step_lanes, rk4_step_rows, rollout_rows,
                         wrap_angles_lanes, wrap_angles_rows)
from ..ops.solver import NLSConfig, NLSOutputs, NLSTerminationState
from .controller import MPC, MPCOutputs, MPCState

__all__ = ["step_lanes", "simulator_step_lanes", "tick_fn_lanes"]


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


def _solve_lanes(problem: _LanesProblem, Z0: _Z, config: NLSConfig):
    """The lanes damped-GN solve at full f32 matmul precision, whatever the
    caller's global setting; the caller's setting is restored on exit."""
    with full_f32_matmul():
        return _solve_lanes_impl(problem, Z0, config)


def _solve_lanes_impl(problem: _LanesProblem, Z0: _Z, config: NLSConfig):
    """The fixed-trip damped-GN solve (the plain fused iteration,
    ``max_iterations`` times), then the final residual evaluation."""
    B = problem.B
    (xs, u, lam, _, _, _, term, first_order), traces = fused_solve(
        problem.statics.fused, problem.dynamics_params, problem.x_current,
        problem.set_point, problem.u_prev, _init_carry(Z0, config),
        config.max_iterations,
    )
    Z = _Z(xs=xs, u=u)
    iter_cost, iter_viol, iter_lambda, iter_alpha, iter_first, applied = traces

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
        # (iters, B) -> (B, iters): the batch-first layout of the reference.
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
def step_lanes(mpc: MPC, state: MPCState, x_current, dynamics_params,
               b_x_set_point=0.0):
    """Batched MPC step in the lanes layout, the counterpart of the
    reference's ``step_lanes``: ``state`` fields and ``x_current`` ``(B,
    sd)`` carry a LEADING batch axis; internally the batch is the trailing
    axis. Requires ``kkt_method="condensed"``."""
    if mpc.params.kkt_method != "condensed":
        raise ValueError(
            "step_lanes implements the condensed KKT path only; got "
            f"kkt_method={mpc.params.kkt_method!r}"
        )
    spec = mpc.spec
    B, sd = x_current.shape
    N = spec.num_states
    problem, Z0 = _prepare(mpc, state, x_current, dynamics_params,
                           b_x_set_point)
    Z, solver_outputs = _solve_lanes(problem, Z0, mpc.nls_config)

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
                  auto_reset: bool = True):
    """One tick of the lanes closed loop as a function of tensors
    only, ``(x (sd, B), previous_solution (B, dim), warm (B,)[, dist (2, 2,
    B)]) -> (x_next (sd, B), previous_solution, warm, x.T, u0, terminal
    prediction (B, sd), termination codes, constraint violations,
    iterations)``. ``set_point`` is ``(B,)``; ``dist[0]`` and ``dist[1]`` are
    the forces at the base and at the first link mass."""

    def tick(x, previous_solution, warm, dist=None):
        outputs, st = step_lanes(mpc, MPCState(previous_solution, warm),
                                 x.T, dynamics_params, set_point)
        u0 = outputs.u[:, 0]  # (B,)
        if auto_reset:
            failed = mpc.failure_mask(outputs)
            st = mpc.reset_where(st, failed)
            u0 = torch.where(failed, torch.zeros_like(u0), u0)
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
