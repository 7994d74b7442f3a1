"""Replay saved solve logs — the log-as-replayable-record capability
(counterpart of ``cartpole_tpu/utils/replay.py``, framework-free, copied).

The reference's per-solve JSON log (ring of 5000 ``OptimizationOutputs``
payloads saved by the web UI's "Save log" button,
``/root/reference/viz/src/application.ts:344-351,429-434``) doubles as a
replayable record of a closed-loop session: each entry carries the plant
state entering the solve, the control window, and the predicted states.
This module loads such a file back into a trajectory object the offline
stack consumes (``viz.strip_charts``, ``viz.animate_closed_loop``,
``analysis``) — so a session recorded in the browser demo (or by
``python -m cartpole_tpu_torch closed-loop --log-json``) can be re-rendered and
re-analyzed offline.

Both on-disk formats are accepted:

1. the reference-parity ``SolveLog`` format (``utils/logging.py``:
   ``initial_state`` dict / ``u`` window / ``predicted_states`` /
   ``solver_outputs``), and
2. the CLI closed-loop ``--log-json`` format (``state`` list, scalar
   ``u``, ``termination_state`` name).

Logs written by either package read the same.
"""

from __future__ import annotations

import json
from typing import Any, List, NamedTuple, Optional

import numpy as np

from ..ops.solver import termination_state_name

__all__ = ["LogReplay", "load_log", "replay_log"]

_N_TERMINATION_STATES = 5
_NAME_TO_CODE = {
    termination_state_name(k): k for k in range(_N_TERMINATION_STATES)
}


class LogReplay(NamedTuple):
    """A replayed closed-loop trajectory (host numpy arrays).

    ``states``/``controls`` satisfy the same attribute contract as
    ``ClosedLoopResult``, so ``viz.strip_charts`` and
    ``viz.animate_closed_loop`` consume a replay directly.
    """

    states: np.ndarray  #: (T, state_dim) plant state entering each solve.
    controls: np.ndarray  #: (T,) control applied at each tick (u[0]).
    termination_states: np.ndarray  #: (T,) int codes (NLSTerminationState).
    predicted_states: Optional[np.ndarray]  #: (T, N, state_dim) or None.


def load_log(path: str) -> List[dict]:
    """Read a saved ``log.json`` (either format) into its entry list."""
    with open(path) as f:
        entries = json.load(f)
    if not isinstance(entries, list):
        raise ValueError(f"{path}: expected a JSON array of solve entries")
    return entries


def _f(v: Any) -> float:
    """JSON scalar -> float; ``null`` (how the writer spells a non-finite
    value, ``logging._finite``) comes back as NaN."""
    return float("nan") if v is None else float(v)


def _state_from_dict(d: Any) -> List[float]:
    """Undo ``logging._state_dict``: the reference JSON field order is
    [b_x, th_1, th_1_dot, b_x_dot] while the state vector is
    [b_x, th_1, b_x_dot, th_1_dot] (``structs.hpp:44-64``)."""
    if isinstance(d, dict):
        if "x" in d:
            return [_f(v) for v in d["x"]]
        return [_f(d["b_x"]), _f(d["th_1"]), _f(d["b_x_dot"]), _f(d["th_1_dot"])]
    return [_f(v) for v in d]


def _term_code(name: Any) -> int:
    if isinstance(name, (int, np.integer)):
        return int(name)
    try:
        return _NAME_TO_CODE[str(name)]
    except KeyError:
        raise ValueError(
            f"unknown termination state {name!r}; "
            f"known: {sorted(_NAME_TO_CODE)}"
        ) from None


def replay_log(entries: List[dict]) -> LogReplay:
    """Rebuild the closed-loop trajectory from saved log entries."""
    if not entries:
        raise ValueError("empty log")
    states, controls, terms, preds = [], [], [], []
    have_preds = all("predicted_states" in e for e in entries)
    for e in entries:
        if "initial_state" in e:  # SolveLog / reference format.
            states.append(_state_from_dict(e["initial_state"]))
            u = e["u"]
            controls.append(_f(u[0] if isinstance(u, list) else u))
            terms.append(
                _term_code(e["solver_outputs"]["termination_state"])
            )
            if have_preds:
                preds.append(
                    [_state_from_dict(p) for p in e["predicted_states"]]
                )
        elif "state" in e:  # CLI closed-loop --log-json format.
            states.append([_f(v) for v in e["state"]])
            controls.append(_f(e["u"]))
            terms.append(_term_code(e.get("termination_state", 0)))
        else:
            raise ValueError(
                f"unrecognized log entry keys {sorted(e)}; expected the "
                "SolveLog format ('initial_state', 'u', ...) or the CLI "
                "closed-loop format ('state', 'u', ...)"
            )
    return LogReplay(
        states=np.asarray(states, np.float64),
        controls=np.asarray(controls, np.float64),
        termination_states=np.asarray(terms, np.int32),
        predicted_states=(
            np.asarray(preds, np.float64) if have_preds and preds else None
        ),
    )
