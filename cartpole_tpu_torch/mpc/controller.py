"""The MPC controller definition (counterpart of
``cartpole_tpu/mpc/controller.py``): the static ``MPC`` object, the
carried ``MPCState`` and the ``MPCOutputs`` tuple. The batched step is
``mpc/lanes.py::step_lanes``; the per-instance ``MPC.step`` is queued in
ROADMAP.md."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models.base import CartPoleModel, SINGLE_CARTPOLE
from ..ops.solver import NLSConfig, NLSOutputs, NLSTerminationState
from .config import OptimizationParams
from .problem import MPCProblemSpec

__all__ = ["MPC", "MPCState", "MPCOutputs", "make_mpc"]


class MPCState(NamedTuple):
    """Carried warm-start state (the reference's ``previous_solution_``)."""

    previous_solution: Any  #: (B, dim) decision vector from the last solve.
    warm: Any  #: (B,) bool — whether previous_solution is valid.


class MPCOutputs(NamedTuple):
    """Analog of ``OptimizationOutputs``; every field batch-first."""

    initial_state: Any  #: (B, state_dim) state the window was solved from.
    previous_solution: Any  #: (B, dim) the initial guess used for this solve.
    solver: NLSOutputs  #: solver diagnostics.
    u: Any  #: (B, window_length) optimized control sequence.
    predicted_states: Any  #: (B, window_length, state_dim) prediction.
    solution: Any  #: (B, dim) full decision vector at the solution.


class MPC:
    """Static MPC definition. Device tensors derived from it (the lanes
    solver's eigenbasis and cost Jacobian) are built once per dtype and
    device and kept in ``statics_cache``."""

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

    def failure_mask(self, outputs: MPCOutputs):
        """Per-instance failure detector: solver termination in
        {QP_INDEFINITE, MAX_LAMBDA} or a non-finite solution."""
        term = outputs.solver.termination_state
        bad = (term == NLSTerminationState.QP_INDEFINITE) | (
            term == NLSTerminationState.MAX_LAMBDA
        )
        finite = torch.all(torch.isfinite(outputs.solution), dim=-1)
        return bad | ~finite

    def reset_where(self, state: MPCState, mask) -> MPCState:
        """Discard warm starts where ``mask`` is True (batched ``Reset()``)."""
        return MPCState(
            previous_solution=torch.where(
                mask[..., None], torch.zeros_like(state.previous_solution),
                state.previous_solution,
            ),
            warm=torch.where(mask, torch.zeros_like(state.warm), state.warm),
        )


def make_mpc(params: OptimizationParams | None = None,
             model: CartPoleModel = SINGLE_CARTPOLE) -> MPC:
    """Construct an MPC controller definition."""
    return MPC(params or OptimizationParams(), model)
