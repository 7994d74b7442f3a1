"""cartpole_tpu_torch — the PyTorch / CUDA port of ``cartpole_tpu``.

The port runs the batched closed-loop MPC main path (``run_closed_loop_lanes``
with the fused Gauss-Newton kernel, and phase schedules of it through
``run_scheduled_closed_loop``) for the single, double and triple cart-pole on
an NVIDIA H100. It imports torch and numpy, never jax; the JAX package
``cartpole_tpu`` is its reference.
"""

from .models.base import (DOUBLE_CARTPOLE, SINGLE_CARTPOLE, TRIPLE_CARTPOLE,
                          get_model)
from .models.params import (DoubleCartPoleParams, SingleCartPoleParams,
                            TripleCartPoleParams, default_double_params,
                            default_single_params, default_triple_params)
from .mpc.config import OptimizationParams
from .mpc.controller import MPC, MPCOutputs, MPCState, make_mpc
from .mpc.lanes import run_closed_loop_lanes, simulator_step_lanes, step_lanes
from .mpc.schedule import run_scheduled_closed_loop

__all__ = [
    "OptimizationParams",
    "make_mpc",
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
]
