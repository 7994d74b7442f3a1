"""Solver types (counterpart of ``cartpole_tpu/ops/solver.py:58-178``):
termination codes, the static solver configuration and the diagnostics
tuple. The solve itself is the fused iteration of ``ops/fused.py``."""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

__all__ = ["NLSTerminationState", "NLSConfig", "NLSOutputs"]


class NLSTerminationState:
    """Integer termination codes (analog of
    ``mini_opt::NLSTerminationState``)."""

    MAX_ITERATIONS = 0
    SATISFIED_RELATIVE_TOL = 1
    SATISFIED_FIRST_ORDER_TOL = 2
    MAX_LAMBDA = 3
    QP_INDEFINITE = 4


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
    kkt_method: str = "lu"


class NLSOutputs(NamedTuple):
    """Solver diagnostics (the ``NLSSolverOutputs`` analog); batch-first."""

    termination_state: Any  #: (B,) int32 code, see NLSTerminationState.
    n_iterations: Any  #: (B,) iterations actually applied (int32).
    cost: Any  #: (B,) final 0.5*||r||^2.
    constraint_violation: Any  #: (B,) final ||c||_inf.
    first_order_norm: Any  #: (B,) final ||J^T r + A^T nu||_inf.
    lambda_final: Any  #: (B,) final LM damping.
    #: Per-iteration traces, each shape (B, max_iterations):
    iter_cost: Any
    iter_violation: Any
    iter_lambda: Any
    iter_step_size: Any  #: accepted line-search alpha (0 if rejected).
    iter_first_order: Any
