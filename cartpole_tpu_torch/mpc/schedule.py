"""Phase-scheduled closed loops (counterpart of
``cartpole_tpu/mpc/schedule.py``).

:func:`run_scheduled_closed_loop` runs a closed loop (one instance, or a
batch in the lanes layout) through a schedule of ``(num_ticks,
overrides)`` phases. A phase's overrides replace ``OptimizationParams``
fields (for example a transient
``u_derivative_cost_weight``, which the double-pole bench regime applies
for its first 50 ticks); the cost weights are static solver structure (the
u-cost Gram matrix and its eigenbasis), so each distinct override set gets
one controller, built once and reused by every phase and chunk that names
it. Plant state and warm start carry across phases and chunks.

Phases keep the decision-vector layout, so the warm start carries as it
is: an override of ``window_length``, ``state_spacing`` or ``control_dt``
raises, even where the decision vector keeps its size (the reference's
guard, ``mpc/schedule.py:55``, compares only that size).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple

import torch

from .closed_loop import ClosedLoopResult, run_closed_loop
from .controller import MPC, MPCState, make_mpc

__all__ = ["run_scheduled_closed_loop"]

#: Schedule entry: (number of ticks, OptimizationParams field overrides).
#: ``None`` or ``{}`` overrides mean "the base controller".
ScheduleEntry = Tuple[int, Optional[Mapping[str, Any]]]

#: Fields that set the decision-vector layout or the tick the warm start is
#: shifted by: a phase may not change them.
LAYOUT_FIELDS = ("window_length", "state_spacing", "control_dt")


def _phase_mpc(mpc: MPC, overrides: Optional[Mapping[str, Any]]) -> MPC:
    if not overrides:
        return mpc
    fixed = sorted(set(overrides) & set(LAYOUT_FIELDS))
    if fixed:
        raise ValueError(
            "schedule overrides must keep the decision-vector layout and the "
            f"control tick the warm start carries over: {fixed} may not "
            f"change (overrides {dict(overrides)})")
    return make_mpc(dataclasses.replace(mpc.params, **dict(overrides)),
                    mpc.model)


def _concat_results(parts: Sequence[ClosedLoopResult],
                    tick_axis: int) -> ClosedLoopResult:
    """One result over the tick axis of every part."""
    last = parts[-1]

    def cat(name):
        return torch.cat([getattr(p, name) for p in parts], dim=tick_axis)

    return ClosedLoopResult(
        final_state=last.final_state,
        final_mpc_state=last.final_mpc_state,
        states=cat("states"),
        controls=cat("controls"),
        terminal_predictions=cat("terminal_predictions"),
        termination_states=cat("termination_states"),
        constraint_violations=cat("constraint_violations"),
        solver_iterations=cat("solver_iterations"),
    )


def run_scheduled_closed_loop(
    mpc: MPC,
    x0,
    dynamics_params,
    schedule: Sequence[ScheduleEntry],
    set_point=0.0,
    mpc_state: Optional[MPCState] = None,
    layout: str = "single",
    fused: bool = False,
    auto_reset: bool = True,
    max_ticks_per_program: int = 50,
    on_chunk: Optional[Callable[[ClosedLoopResult], None]] = None,
) -> ClosedLoopResult:
    """Run a closed loop through a schedule of solver-parameter phases.

    ``schedule`` is a sequence of ``(num_ticks, overrides)``: ``overrides``
    is a dict of ``OptimizationParams`` fields (e.g.
    ``{"u_derivative_cost_weight": 0.8}``) or ``None`` for the base
    controller. Each phase runs in chunks of at most
    ``max_ticks_per_program`` ticks, and the result covers every tick.

    ``layout="single"`` (the default, as in the reference) runs one
    instance, ``x0`` ``(sd,)``, through
    ``mpc/closed_loop.py::run_closed_loop``; ``layout="lanes"`` runs a
    batch, ``x0`` ``(B, sd)``, through ``mpc/lanes.py::run_closed_loop_lanes``
    with ``fused`` picking the solve body. The reference's ``use_jit`` has
    no counterpart: a chunk is one call, which on the card runs its first
    tick eagerly and replays a CUDA-graph capture of its tick for the rest
    (the reference compiles a chunk into one program), and releases the
    graph when it returns.

    ``on_chunk``, if given, is called with each chunk's result as the
    chunk's call returns (a caller can read the card's memory there).
    """
    from .lanes import run_closed_loop_lanes

    if layout not in ("single", "lanes"):
        raise ValueError(f"unknown layout {layout!r}")
    if not schedule:
        raise ValueError("schedule must have at least one phase")
    chunk = int(max_ticks_per_program)
    if chunk < 1:
        raise ValueError("max_ticks_per_program must be >= 1")

    x, state = x0, mpc_state
    controllers: dict = {}  # override key -> MPC
    parts = []
    for n_ticks, overrides in schedule:
        n_ticks = int(n_ticks)
        if n_ticks < 1:
            raise ValueError("each schedule phase needs >= 1 ticks")
        key = tuple(sorted(dict(overrides or {}).items()))
        if key not in controllers:
            controllers[key] = _phase_mpc(mpc, overrides)
        phase_mpc = controllers[key]
        remaining = n_ticks
        while remaining > 0:
            n = min(remaining, chunk)
            if layout == "lanes":
                res = run_closed_loop_lanes(
                    phase_mpc, x, dynamics_params, n, set_point,
                    mpc_state=state, auto_reset=auto_reset, fused=fused)
            else:
                res = run_closed_loop(
                    phase_mpc, x, dynamics_params, n, set_point,
                    mpc_state=state, auto_reset=auto_reset)
            parts.append(res)
            if on_chunk is not None:
                on_chunk(res)
            x, state = res.final_state, res.final_mpc_state
            remaining -= n
    return _concat_results(parts, tick_axis=1 if layout == "lanes" else 0)
