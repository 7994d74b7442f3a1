"""Phase-scheduled closed loops (counterpart of
``cartpole_tpu/mpc/schedule.py``).

:func:`run_scheduled_closed_loop` runs a batched closed loop through a
schedule of ``(num_ticks, overrides)`` phases. A phase's overrides replace
``OptimizationParams`` fields (for example a transient
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
from typing import Any, Mapping, Optional, Sequence, Tuple

import torch

from .closed_loop import ClosedLoopResult
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


def _concat_results(parts: Sequence[ClosedLoopResult]) -> ClosedLoopResult:
    """One result over the tick axis (axis 1) of every part."""
    last = parts[-1]

    def cat(name):
        return torch.cat([getattr(p, name) for p in parts], dim=1)

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
) -> ClosedLoopResult:
    """Run a batched closed loop through a schedule of solver-parameter
    phases.

    ``schedule`` is a sequence of ``(num_ticks, overrides)``: ``overrides``
    is a dict of ``OptimizationParams`` fields (e.g.
    ``{"u_derivative_cost_weight": 0.8}``) or ``None`` for the base
    controller. ``x0`` is ``(B, sd)``; each phase runs
    ``mpc/lanes.py::run_closed_loop_lanes`` with ``fused`` picking the solve
    body, in chunks of at most ``max_ticks_per_program`` ticks, and the
    result covers every tick.

    ``layout`` defaults to ``"single"`` as in the reference, and
    ``"single"`` (one instance through the per-instance closed loop) raises
    ``NotImplementedError``: that loop is not ported yet; pass
    ``layout="lanes"``. The
    reference's ``use_jit`` has no counterpart: the port runs eagerly, and
    a chunk is a call, not a compiled program.
    """
    from .lanes import run_closed_loop_lanes

    if layout == "single":
        raise NotImplementedError(
            "layout='single' needs mpc/closed_loop.py::run_closed_loop, the "
            "per-instance path (ROADMAP.md queue 1, item 2: the generic "
            "per-instance path); use layout='lanes'")
    if layout != "lanes":
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
            res = run_closed_loop_lanes(
                phase_mpc, x, dynamics_params, n, set_point,
                mpc_state=state, auto_reset=auto_reset, fused=fused)
            parts.append(res)
            x, state = res.final_state, res.final_mpc_state
            remaining -= n
    return _concat_results(parts)
