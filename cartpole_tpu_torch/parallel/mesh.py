"""Scenario meshes over ``torch.distributed`` (counterpart of
``cartpole_tpu/parallel/mesh.py``).

A "mesh" here is a process group over scenario shards: one rank per device
or per process, each holding a contiguous slice of the scenario batch.
MPC instances are independent, so a flat group is the whole topology, and
the only traffic across it is the diagnostics reduction
(``parallel/sharded.py``). Ranks join through ``torchrun`` (which sets
``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``) or through
explicit arguments to :func:`initialize_distributed`.

``scenario_sharding`` and ``replicated_sharding`` have no counterpart in
torch: a tensor here lives whole on one rank, and there is no sharding
object to place it by. Each is a one-line stand-in that returns the slice
of the batch axis that the rank holds (all of it, for a replicated value),
so that a reader of the reference finds them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

__all__ = [
    "ScenarioMesh",
    "initialize_distributed",
    "make_scenario_mesh",
    "scenario_sharding",
    "replicated_sharding",
    "shard_scenarios",
    "host_local_batch",
]


def _auto_backend() -> str:
    """NCCL when every local rank has a card of its own, else gloo (NCCL
    refuses two ranks on one device)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if torch.cuda.is_available() and local <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Join a multi-process run (a no-op for a single process).

    Multi-process is OPT-IN, as in the reference: pass ``world_size`` and
    ``rank`` (and ``init_method``, e.g. ``"tcp://localhost:29500"``), or run
    under ``torchrun``, which sets ``MASTER_ADDR`` and ``WORLD_SIZE``. With
    no such signal, or ``world_size`` <= 1, or a group already up, this
    returns without initializing. ``backend`` defaults to NCCL when each
    local rank has a card of its own and to gloo otherwise.
    """
    if world_size is not None and world_size <= 1:
        return
    if dist.is_initialized():
        return
    if (init_method is None and world_size is None
            and "MASTER_ADDR" not in os.environ
            and "WORLD_SIZE" not in os.environ):
        return
    kwargs = {}
    if init_method is not None:
        kwargs["init_method"] = init_method
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    dist.init_process_group(backend=backend or _auto_backend(), **kwargs)


@dataclasses.dataclass(frozen=True)
class ScenarioMesh:
    """The rank's view of the scenario group."""

    world_size: int  #: ranks in the group.
    rank: int  #: this rank.
    device: torch.device  #: where this rank's scenarios live.
    #: The process group, or ``None`` for a single process (local
    #: reductions only).
    group: Any = None

    @property
    def comm_device(self) -> torch.device:
        """Where collectives run: the card under NCCL, the host under gloo
        (whose reductions take CUDA tensors for some ops only)."""
        if self.group is not None and dist.get_backend(self.group) == "nccl":
            return self.device
        return torch.device("cpu")


def make_scenario_mesh(device=None) -> ScenarioMesh:
    """World size, rank and device of this process.

    ``device`` defaults to ``cuda:{LOCAL_RANK % device_count}``; the CPU
    only when the caller asks for it. Without a CUDA device and without
    ``device`` this raises, rather than carry on on the CPU.
    """
    if dist.is_initialized():
        world, rank, group = dist.get_world_size(), dist.get_rank(), \
            dist.group.WORLD
    else:
        world, rank, group = 1, 0, None
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run the "
                               "scenarios on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = f"cuda:{local % torch.cuda.device_count()}"
        if world > 1:
            # Collectives on the card (NCCL) run on the current device.
            torch.cuda.set_device(device)
    return ScenarioMesh(world, rank, torch.device(device),
                        group if world > 1 else None)


def host_local_batch(global_batch: int, mesh: ScenarioMesh) -> int:
    """Scenarios per rank for an evenly divisible global batch."""
    n = mesh.world_size
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by mesh size {n}")
    return global_batch // n


def scenario_sharding(mesh: ScenarioMesh, global_batch: int) -> slice:
    """The rank's contiguous slice of a leading batch axis."""
    n = host_local_batch(global_batch, mesh)
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def replicated_sharding(mesh: ScenarioMesh) -> slice:
    """Every rank holds the whole value."""
    return slice(None)


def shard_scenarios(tree: Any, mesh: ScenarioMesh) -> Any:
    """The rank's slice of every leaf's leading axis, on the rank's device.

    Leaves may be tensors or numpy arrays; every leaf must have the same
    leading dimension, divisible by the world size (as in the reference).
    """
    leaves = [torch.as_tensor(v) for v in pytree.tree_leaves(tree)]
    sizes = {int(v.shape[0]) for v in leaves}
    if len(sizes) != 1:
        raise ValueError(f"leaves disagree on the batch axis: {sorted(sizes)}")
    sl = scenario_sharding(mesh, sizes.pop())
    return pytree.tree_map(
        lambda v: torch.as_tensor(v)[sl].to(mesh.device), tree)
