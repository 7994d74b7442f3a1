"""The MPC controller (counterpart of ``cartpole_tpu/mpc/controller.py``):
the static ``MPC`` object, the carried ``MPCState`` and the ``MPCOutputs``
tuple.

``MPC.step`` is one receding-horizon solve of ONE instance (the reference's
``Step``, ``optimization.cc``); batch it with ``torch.func.vmap``, or run a
batch through ``mpc/lanes.py::step_lanes``, whose layout keeps the batch in
the trailing axis. ``failure_mask`` and ``reset_where`` take one instance's
state and outputs or a batch's.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..models.base import CartPoleModel, SINGLE_CARTPOLE
from ..ops.integrate import mod_pi, rollout
from ..ops.solver import (NLSConfig, NLSOutputs, NLSProblem,
                          NLSTerminationState, solve_nls)
from .config import OptimizationParams
from .problem import MPCProblemSpec

__all__ = ["MPC", "MPCState", "MPCOutputs", "make_mpc"]


class MPCState(NamedTuple):
    """Carried warm-start state (the reference's ``previous_solution_``).
    One instance's fields are ``(dim,)`` and a 0-d bool; a batch's carry a
    leading batch axis."""

    previous_solution: Any  #: (dim,) decision vector from the last solve.
    warm: Any  #: bool — whether previous_solution is valid.


class MPCOutputs(NamedTuple):
    """Analog of ``OptimizationOutputs``. Shapes are one instance's; a
    batch puts its axis first."""

    initial_state: Any  #: (state_dim,) state the window was solved from.
    previous_solution: Any  #: (dim,) the initial guess used for this solve.
    solver: NLSOutputs  #: solver diagnostics.
    u: Any  #: (window_length,) optimized control sequence.
    predicted_states: Any  #: (window_length, state_dim) prediction.
    solution: Any  #: (dim,) full decision vector at the solution.


class MPC:
    """Static MPC definition. Device tensors derived from it (the lanes
    solver's eigenbasis and cost Jacobian) are built once per dtype and
    device and kept in ``statics_cache``; the per-instance problem keeps
    its own in ``spec``."""

    def __init__(self, params: OptimizationParams,
                 model: CartPoleModel = SINGLE_CARTPOLE):
        self.params = params
        self.model = model
        self.spec = MPCProblemSpec(params, model)
        self.nls_config = NLSConfig(
            max_iterations=params.max_iterations,
            max_line_search_iterations=params.max_line_search_iterations,
            relative_exit_tol=params.relative_exit_tol,
            absolute_first_derivative_tol=params.absolute_first_derivative_tol,
            equality_penalty_initial=params.equality_penalty_initial,
            kkt_method=params.kkt_method,
        )
        self.statics_cache: dict = {}

    # ------------------------------------------------------------------ state
    def init_state(self, dtype=torch.float32, device="cuda") -> MPCState:
        """Cold-start state of one instance (the ``Reset()`` analog), on
        ``device`` (the card unless the caller asks for the CPU)."""
        return MPCState(
            previous_solution=torch.zeros((self.spec.dim,), dtype=dtype,
                                          device=device),
            warm=torch.zeros((), dtype=torch.bool, device=device),
        )

    def reset(self, state: MPCState) -> MPCState:
        ps = state.previous_solution
        return self.init_state(ps.dtype, ps.device)

    def reset_where(self, state: MPCState, mask) -> MPCState:
        """Discard warm starts where ``mask`` is True (batched ``Reset()``):
        ``mask`` is 0-d for one instance, ``(B,)`` for a batch."""
        return MPCState(
            previous_solution=torch.where(
                mask[..., None], torch.zeros_like(state.previous_solution),
                state.previous_solution,
            ),
            warm=torch.where(mask, torch.zeros_like(state.warm), state.warm),
        )

    def set_previous_solution(self, state: MPCState, guess) -> MPCState:
        """``SetPreviousSolution`` analog: ``guess`` becomes the warm
        start."""
        ps = state.previous_solution
        guess = torch.as_tensor(guess, dtype=ps.dtype, device=ps.device)
        return MPCState(previous_solution=guess,
                        warm=torch.ones_like(state.warm))

    def failure_mask(self, outputs: MPCOutputs):
        """Per-instance failure detector: solver termination in
        {QP_INDEFINITE, MAX_LAMBDA} or a non-finite solution."""
        term = outputs.solver.termination_state
        bad = (term == NLSTerminationState.QP_INDEFINITE) | (
            term == NLSTerminationState.MAX_LAMBDA
        )
        finite = torch.all(torch.isfinite(outputs.solution), dim=-1)
        return bad | ~finite

    def knockdown_mask(self, x, angle_threshold: float = 0.5):
        """Plant-state knockdown detector: any pole angle more than
        ``angle_threshold`` rad from upright. ``x`` is ``(..., state_dim)``;
        returns a ``(...,)`` bool mask. A knocked-down instance usually has
        healthy solves: the plant fell over (``scripts/probe_knockdowns.py``
        characterizes the double pole's)."""
        th = torch.stack([x[..., a] for a in self.model.angle_indices],
                         dim=-1)
        err = mod_pi(th - math.pi / 2)
        return torch.any(torch.abs(err) > angle_threshold, dim=-1)

    def knockdown_report(self, states, angle_threshold: float = 0.5,
                         stuck_after: int = 100):
        """Knockdown analysis of a recorded trajectory ``states`` ``(B, T,
        state_dim)``: ``(down (B, T) bool, first_down_tick (B,) int32 or -1,
        stuck (B,) bool)``, where stuck means down for the final
        ``stuck_after`` ticks."""
        down = self.knockdown_mask(states, angle_threshold)
        T = down.shape[-1]
        ever = torch.any(down, dim=-1)
        first = torch.where(ever, torch.argmax(down.to(torch.int32), dim=-1),
                            -1).to(torch.int32)
        tail = min(stuck_after, T)
        stuck = torch.all(down[..., T - tail:], dim=-1)
        return down, first, stuck

    # ------------------------------------------------------------------- guess
    def _initial_guess(self, state: MPCState, x_current):
        """Warm start (controls shifted one step, ``optimization.cc:50-57``)
        or the sinusoidal cold start (``:61-67``); and the continuity
        control ``u_prev``."""
        spec = self.spec
        dtype, device = x_current.dtype, x_current.device
        K = spec.window_length
        u_prev = state.previous_solution.to(dtype)[spec.u_start:]
        u_warm = torch.cat([u_prev[1:], u_prev[-1:]])
        k = torch.arange(K, dtype=dtype, device=device)
        u_cold = self.params.u_guess_sinusoid_amplitude * torch.sin(
            k / K * (2.0 * math.pi))
        u_guess = torch.where(state.warm, u_warm, u_cold)
        u_prev_continuity = torch.where(state.warm, u_prev[0], 0.0)
        return u_guess, u_prev_continuity

    # -------------------------------------------------------------------- step
    def step(self, state: MPCState, x_current, dynamics_params,
             b_x_set_point=0.0):
        """One receding-horizon solve of one instance from ``x_current``
        ``(state_dim,)``; returns ``(MPCOutputs, MPCState)``. Runs on
        ``x_current``'s device and reads nothing back to the host; batch it
        with ``torch.func.vmap`` over ``state`` and ``x_current``."""
        spec = self.spec
        dtype = x_current.dtype
        set_point = (b_x_set_point.to(dtype)
                     if isinstance(b_x_set_point, torch.Tensor)
                     else float(b_x_set_point))

        u_guess, u_prev_continuity = self._initial_guess(state, x_current)

        def f(x, u):
            return self.model.dynamics(dynamics_params, x, u)

        dt, angle = self.params.control_dt, self.model.angle_indices
        _, xs_roll = rollout(f, x_current, u_guess, dt, angle)
        # Shooting-state guesses: x_current and every spacing-th state.
        shoot = torch.cat([x_current[None], xs_roll[spec.spacing - 1::
                                                    spec.spacing]])
        z_guess = torch.cat([shoot.reshape(-1), u_guess])

        linearize, evaluate, retract = spec.make_problem_fns(
            x_current, set_point, u_prev_continuity, dynamics_params)
        condensed = (
            spec.make_condensed_step(x_current, set_point,
                                     u_prev_continuity, dynamics_params)
            if self.params.kkt_method == "condensed" else None)
        problem = NLSProblem(linearize=linearize, evaluate=evaluate,
                             retract=retract, condensed_step=condensed)
        z_sol, solver_outputs = solve_nls(problem, z_guess, self.nls_config)

        u_out = z_sol[spec.u_start:]
        _, predicted = rollout(f, x_current, u_out, dt, angle)
        outputs = MPCOutputs(
            initial_state=x_current,
            previous_solution=z_guess,
            solver=solver_outputs,
            u=u_out,
            predicted_states=predicted,
            solution=z_sol,
        )
        return outputs, MPCState(previous_solution=z_sol,
                                 warm=torch.ones_like(state.warm))


def make_mpc(params: OptimizationParams | None = None,
             model: CartPoleModel = SINGLE_CARTPOLE) -> MPC:
    """Construct an MPC controller definition."""
    return MPC(params or OptimizationParams(), model)
