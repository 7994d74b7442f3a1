"""Closed-loop result tuple (counterpart of
``cartpole_tpu/mpc/closed_loop.py:27-35``). The batched loop is
``mpc/lanes.py::run_closed_loop_lanes``."""

from __future__ import annotations

from typing import Any, NamedTuple

from .controller import MPCState

__all__ = ["ClosedLoopResult"]


class ClosedLoopResult(NamedTuple):
    final_state: Any  #: (B, state_dim) plant state after the last step.
    final_mpc_state: MPCState
    states: Any  #: (B, num_steps, state_dim) plant state at each tick.
    controls: Any  #: (B, num_steps) applied u[0] at each tick.
    terminal_predictions: Any  #: (B, num_steps, state_dim) terminal state.
    termination_states: Any  #: (B, num_steps) solver termination codes.
    constraint_violations: Any  #: (B, num_steps) final ||c||_inf per solve.
    solver_iterations: Any  #: (B, num_steps) iterations used per solve.
