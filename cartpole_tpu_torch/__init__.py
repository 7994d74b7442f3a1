"""cartpole_tpu_torch — the PyTorch / CUDA port of ``cartpole_tpu``.

The port runs the batched closed-loop MPC main path (``run_closed_loop_lanes``
with the fused Gauss-Newton kernel, and phase schedules of it through
``run_scheduled_closed_loop``) for the single, double and triple cart-pole on
an NVIDIA H100, and the reference's per-instance path (``MPC.step``,
``solve_nls`` with its ``lu``, ``schur`` and ``condensed`` KKT paths,
``run_closed_loop``, the plant ``Simulator``), which batches with
``torch.func.vmap``, and differentiable MPC (``make_differentiable_solve``:
gradients through one solve, a ``torch.autograd.Function``). It imports
torch and numpy, never jax; the JAX package ``cartpole_tpu`` is its
reference.
"""

from .diff import make_differentiable_solve
from .models.base import (DOUBLE_CARTPOLE, SINGLE_CARTPOLE, TRIPLE_CARTPOLE,
                          get_model)
from .models.params import (DoubleCartPoleParams, SingleCartPoleParams,
                            TripleCartPoleParams, default_double_params,
                            default_single_params, default_triple_params)
from .mpc.closed_loop import ClosedLoopResult, closed_loop_step, run_closed_loop
from .mpc.config import OptimizationParams
from .mpc.controller import MPC, MPCOutputs, MPCState, make_mpc
from .mpc.lanes import run_closed_loop_lanes, simulator_step_lanes, step_lanes
from .mpc.schedule import run_scheduled_closed_loop
from .mpc.simulator import Simulator, simulator_step
from .ops.solver import (NLSConfig, NLSOutputs, NLSProblem,
                         NLSTerminationState, solve_nls,
                         termination_state_name)

__all__ = [
    "OptimizationParams",
    "make_mpc",
    "make_differentiable_solve",
    "get_model",
    "SINGLE_CARTPOLE",
    "DOUBLE_CARTPOLE",
    "TRIPLE_CARTPOLE",
    "default_single_params",
    "default_double_params",
    "default_triple_params",
    "SingleCartPoleParams",
    "DoubleCartPoleParams",
    "TripleCartPoleParams",
    "MPC",
    "MPCState",
    "MPCOutputs",
    "step_lanes",
    "run_closed_loop_lanes",
    "run_scheduled_closed_loop",
    "simulator_step_lanes",
    "ClosedLoopResult",
    "run_closed_loop",
    "closed_loop_step",
    "Simulator",
    "simulator_step",
    "NLSConfig",
    "NLSOutputs",
    "NLSProblem",
    "NLSTerminationState",
    "solve_nls",
    "termination_state_name",
]
