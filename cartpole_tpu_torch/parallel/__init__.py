"""Scenario-parallel execution over ``torch.distributed`` (counterpart of
``cartpole_tpu/parallel``).

* **batch axis**: thousands of independent MPC instances per card, through
  the lanes layout or ``torch.func.vmap``;
* **group axis**: the scenario batch split in contiguous slices across
  ranks (one per card, or several processes on one card under gloo); the
  solve never communicates, and the only collectives are the all-reduced
  diagnostics.
"""

from .mesh import (
    ScenarioMesh,
    host_local_batch,
    initialize_distributed,
    make_scenario_mesh,
    replicated_sharding,
    scenario_sharding,
    shard_scenarios,
)
from .sharded import (
    BatchDiagnostics,
    gather_scenarios,
    make_sharded_closed_loop,
    make_sharded_step,
    reduce_diagnostics,
)

__all__ = [
    "BatchDiagnostics",
    "ScenarioMesh",
    "gather_scenarios",
    "host_local_batch",
    "initialize_distributed",
    "make_scenario_mesh",
    "make_sharded_closed_loop",
    "make_sharded_step",
    "reduce_diagnostics",
    "replicated_sharding",
    "scenario_sharding",
    "shard_scenarios",
]
