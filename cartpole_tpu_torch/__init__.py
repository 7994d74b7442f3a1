"""cartpole_tpu_torch — the PyTorch / CUDA port of ``cartpole_tpu``.

The port runs the batched closed-loop MPC main path (``run_closed_loop_lanes``
with the fused Gauss-Newton kernel) on an NVIDIA H100. It imports torch and
numpy, never jax; the JAX package ``cartpole_tpu`` is its reference.
"""

from .models.base import get_model
from .models.params import SingleCartPoleParams, default_single_params
from .mpc.config import OptimizationParams
from .mpc.controller import MPC, MPCOutputs, MPCState, make_mpc
from .mpc.lanes import run_closed_loop_lanes, simulator_step_lanes, step_lanes

__all__ = [
    "OptimizationParams",
    "make_mpc",
    "get_model",
    "default_single_params",
    "SingleCartPoleParams",
    "MPC",
    "MPCState",
    "MPCOutputs",
    "step_lanes",
    "run_closed_loop_lanes",
    "simulator_step_lanes",
]
