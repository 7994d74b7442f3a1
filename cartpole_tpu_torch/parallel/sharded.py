"""Scenario-sharded MPC with all-reduced diagnostics (counterpart of
``cartpole_tpu/parallel/sharded.py``).

Each rank runs its own slice of the batch (``mesh.shard_scenarios``) through
the batched solve of its layout; the solve itself never communicates. The
only collectives are the global diagnostics: one ``all_reduce`` with
``ReduceOp.SUM`` for the counters and one with ``ReduceOp.MAX`` for the
maxima (the reference builds its max from sums, a TPU-runtime workaround
that torch does not need). Layouts:

* ``"vmap"``: ``torch.func.vmap`` of ``MPC.step`` / ``run_closed_loop``
  (the per-instance path, any ``kkt_method``);
* ``"lanes"``: ``mpc/lanes.py::step_lanes`` /
  ``run_closed_loop_lanes(fused=False)``, whose linearization is kernel 2;
* ``"lanes-fused"``: the same with ``fused=True``, one launch of kernel 1 a
  solve.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch.func import vmap

from ..mpc.closed_loop import run_closed_loop
from ..mpc.controller import MPC
from ..ops.solver import NLSOutputs, NLSTerminationState
from .mesh import ScenarioMesh

__all__ = [
    "BatchDiagnostics",
    "reduce_diagnostics",
    "make_sharded_step",
    "make_sharded_closed_loop",
    "gather_scenarios",
]

_N_TERMINATION_STATES = 5
_LAYOUTS = ("vmap", "lanes", "lanes-fused")


class BatchDiagnostics(NamedTuple):
    """Globally reduced solver health for a batch of MPC instances."""

    n_instances: Any  #: int32 total instances across the group.
    n_converged: Any  #: int32 instances that hit a SATISFIED_* state.
    n_failed: Any  #: int32 instances that hit QP_INDEFINITE / MAX_LAMBDA.
    termination_counts: Any  #: (5,) int32 histogram over NLSTerminationState.
    max_violation: Any  #: global max final ||c||_inf.
    max_first_order: Any  #: global max final ||grad L||_inf.
    mean_iterations: Any  #: mean applied solver iterations.
    mean_cost: Any  #: mean final cost.


def _all_reduce(t: torch.Tensor, op, mesh) -> torch.Tensor:
    """``t`` reduced over ``mesh``'s group (``None``, or a single process,
    leaves it local), on ``mesh.comm_device``."""
    if mesh is None or mesh.group is None:
        return t
    buf = t.to(mesh.comm_device)
    dist.all_reduce(buf, op=op, group=mesh.group)
    return buf.to(t.device)


def _diagnostics(term, iterations, n_instances, maxima, sum_cost, mesh):
    """Reduce local counters and maxima to :class:`BatchDiagnostics`.

    ``term`` is a flat vector of termination codes (one per solve),
    ``iterations`` the matching iteration counts, ``n_instances`` the local
    instance count; ``maxima`` holds the local max violation and, where the
    caller tracks it, the max first-order norm; ``sum_cost`` is the f32 sum
    of final costs, or ``None`` where the caller does not track it. What is
    not tracked is not reduced and reads NaN. The means are over solves.
    The counters travel as one f64 vector (exact for these integer counts),
    the maxima as another."""
    codes = torch.arange(_N_TERMINATION_STATES, device=term.device)
    counts = (term.reshape(-1, 1).long() == codes).sum(0)
    sums = [
        counts.double(),
        torch.tensor([term.shape[0], n_instances], dtype=torch.float64,
                     device=term.device),
        iterations.float().sum().double().reshape(1),
    ]
    if sum_cost is not None:
        sums.append(sum_cost.double().reshape(1))
    sums = _all_reduce(torch.cat(sums), dist.ReduceOp.SUM, mesh)
    maxima = _all_reduce(maxima, dist.ReduceOp.MAX, mesh)
    k = _N_TERMINATION_STATES
    counts = sums[:k].to(torch.int32)
    n_solves = torch.clamp(sums[k].float(), min=1.0)
    nan = torch.tensor(float("nan"), device=maxima.device)
    s = NLSTerminationState
    return BatchDiagnostics(
        n_instances=sums[k + 1].to(torch.int32),
        n_converged=counts[s.SATISFIED_RELATIVE_TOL]
        + counts[s.SATISFIED_FIRST_ORDER_TOL],
        n_failed=counts[s.QP_INDEFINITE] + counts[s.MAX_LAMBDA],
        termination_counts=counts,
        max_violation=maxima[0],
        max_first_order=maxima[1] if maxima.numel() > 1 else nan,
        mean_iterations=sums[k + 2].float() / n_solves,
        mean_cost=(sums[k + 3].float() / n_solves if sum_cost is not None
                   else nan),
    )


def reduce_diagnostics(solver: NLSOutputs,
                       group: Optional[ScenarioMesh] = None
                       ) -> BatchDiagnostics:
    """Reduce per-instance ``NLSOutputs`` (leading batch axis) to global
    health counters: across the ranks of ``group`` (a ``ScenarioMesh``),
    or locally when it is ``None``."""
    term = solver.termination_state.reshape(-1)
    maxima = torch.stack([torch.max(solver.constraint_violation),
                          torch.max(solver.first_order_norm)])
    return _diagnostics(term, solver.n_iterations, term.shape[0], maxima,
                        torch.sum(solver.cost.float()), group)


def _check_layout(layout: str) -> None:
    if layout not in _LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")


def make_sharded_step(mpc: MPC, mesh: ScenarioMesh,
                      batched_params: bool = False, layout: str = "vmap"):
    """The rank's batched MPC step with globally reduced diagnostics.

    Returns ``step(states, xs, dynamics_params, set_points) -> (outputs,
    new_states, BatchDiagnostics)``: ``states``, ``xs`` and ``set_points``
    are the rank's slices (``shard_scenarios``) with a leading batch axis,
    and so are the results; the diagnostics cover every rank. With
    ``batched_params=True`` every leaf of ``dynamics_params`` carries the
    rank's slice of the batch axis too (parameter-grid sweeps); otherwise
    one plant model serves every scenario.
    """
    _check_layout(layout)
    if layout == "vmap":
        batched = vmap(mpc.step, in_dims=(0, 0, 0 if batched_params else None,
                                          0))
    else:
        from ..mpc.lanes import step_lanes

        fused = layout == "lanes-fused"

        def batched(st, xs, dp, sp):
            return step_lanes(mpc, st, xs, dp, sp, fused=fused)

    def step(states, xs, dynamics_params, set_points):
        outputs, new_states = batched(states, xs, dynamics_params,
                                      set_points)
        return outputs, new_states, reduce_diagnostics(outputs.solver, mesh)

    return step


def make_sharded_closed_loop(mpc: MPC, mesh: ScenarioMesh, num_steps: int,
                             batched_params: bool = False,
                             layout: str = "vmap"):
    """The rank's batched closed loop with globally reduced diagnostics.

    Returns ``run(x0s, dynamics_params, set_points) -> (ClosedLoopResult,
    BatchDiagnostics)``: the rank's ``num_steps`` receding-horizon ticks
    (solve, 1 kHz plant, warm-start carry) over its slice of the batch, and
    one reduction at the end over every tick of every instance of every
    rank. ``batched_params`` and ``layout`` as in :func:`make_sharded_step`.
    """
    _check_layout(layout)
    if layout == "vmap":
        batched = vmap(
            lambda x0, dp, sp: run_closed_loop(mpc, x0, dp, num_steps, sp),
            in_dims=(0, 0 if batched_params else None, 0))
    else:
        from ..mpc.lanes import run_closed_loop_lanes

        fused = layout == "lanes-fused"

        def batched(x0s, dp, sp):
            return run_closed_loop_lanes(mpc, x0s, dp, num_steps, sp,
                                         fused=fused)

    def run(x0s, dynamics_params, set_points):
        result = batched(x0s, dynamics_params, set_points)
        # The first-order norm and the cost are not tracked per tick (as in
        # the reference): they read NaN.
        diag = _diagnostics(result.termination_states.reshape(-1),
                            result.solver_iterations, x0s.shape[0],
                            torch.max(result.constraint_violations).reshape(1),
                            None, mesh)
        return result, diag

    return run


def gather_scenarios(tree: Any, mesh: ScenarioMesh) -> Any:
    """Every rank's slice of each leaf's leading axis, concatenated in rank
    order on every rank (the inverse of ``shard_scenarios``); the tree
    itself for a single process. ``ClosedLoopResult`` and ``MPCOutputs``
    gather whole."""
    if mesh.group is None:
        return tree

    def one(t):
        t = torch.as_tensor(t)
        buf = t.to(mesh.comm_device).contiguous()
        parts = [torch.empty_like(buf) for _ in range(mesh.world_size)]
        dist.all_gather(parts, buf, group=mesh.group)
        return torch.cat(parts).to(t.device)

    return pytree.tree_map(one, tree)

