"""Structured JSON solve logs and human-readable solver summaries
(counterpart of ``cartpole_tpu/utils/logging.py``).

Format parity with the reference's observability surface: the per-solve JSON
written by the web app's "Save log" button (ring buffer of 5000
``OptimizationOutputs.toJson()`` payloads, ``viz/src/application.ts:344-351,
429-434``; serializer field names from ``optimization/wasm.cc:46-65,19-28``)
and the human summary exposed as ``getLog`` / Python ``solver_summary()``
(``wasm.cc:89``, ``wrapper/wrapper.cc:82-83``). A log written here and one
written by the JAX package have the same keys, key for key.
"""

from __future__ import annotations

import collections
import json
from typing import Any, Iterable, List, Optional

import numpy as np
import torch.utils._pytree as pytree

from ..ops.solver import NLSOutputs, termination_state_name
from ._host import host

__all__ = ["solve_log_entry", "solver_summary", "SolveLog"]


def _finite(v) -> Optional[float]:
    """float(v), or None when non-finite: json.dumps would emit literal
    NaN/Infinity tokens that RFC-compliant parsers (JSON.parse, the consumer
    of the reference's "Save log" format) reject. Failed solves legitimately
    produce non-finite cost/first_order_norm."""
    v = float(host(v))
    return v if np.isfinite(v) else None


def _state_dict(x) -> dict:
    x = host(x)
    if x.shape[-1] == 4:
        # Reference field order is [b_x, th_1, th_1_dot, b_x_dot] in JSON but
        # the state vector is [b_x, th_1, b_x_dot, th_1_dot] (structs.hpp:44-64).
        return {
            "b_x": _finite(x[0]),
            "th_1": _finite(x[1]),
            "th_1_dot": _finite(x[3]),
            "b_x_dot": _finite(x[2]),
        }
    return {"x": [_finite(v) for v in x]}


def _solver_dict(solver: NLSOutputs) -> dict:
    def arr(a):
        return [_finite(v) for v in host(a)]

    return {
        "termination_state": termination_state_name(
            int(host(solver.termination_state))),
        "n_iterations": int(host(solver.n_iterations)),
        "cost": _finite(solver.cost),
        "constraint_violation": _finite(solver.constraint_violation),
        "first_order_norm": _finite(solver.first_order_norm),
        "lambda": _finite(solver.lambda_final),
        "iterations": {
            "cost": arr(solver.iter_cost),
            "constraint_violation": arr(solver.iter_violation),
            "lambda": arr(solver.iter_lambda),
            "step_size": arr(solver.iter_step_size),
            "first_order_norm": arr(solver.iter_first_order),
        },
    }


def solve_log_entry(outputs: Any) -> dict:
    """One instance's ``MPCOutputs`` -> the reference's
    ``OptimizationOutputs`` JSON shape (``wasm.cc:57-64``: initial_state,
    previous_solution, solver_outputs, u, predicted_states)."""
    return {
        "initial_state": _state_dict(outputs.initial_state),
        "previous_solution": [_finite(v)
                              for v in host(outputs.previous_solution)],
        "solver_outputs": _solver_dict(outputs.solver),
        "u": [_finite(v) for v in host(outputs.u)],
        "predicted_states": [_state_dict(s)
                             for s in host(outputs.predicted_states)],
    }


def solver_summary(solver: NLSOutputs) -> str:
    """Human-readable per-iteration table (the ``NLSSolverOutputs.ToString()``
    analog surfaced as ``solver_summary()`` in the Python API)."""
    lines = [
        "termination = {}, iterations = {}, cost = {:.6e}, "
        "|c|_inf = {:.3e}, |grad L|_inf = {:.3e}".format(
            termination_state_name(int(host(solver.termination_state))),
            int(host(solver.n_iterations)),
            float(host(solver.cost)),
            float(host(solver.constraint_violation)),
            float(host(solver.first_order_norm)),
        )
    ]
    costs = host(solver.iter_cost)
    viols = host(solver.iter_violation)
    lams = host(solver.iter_lambda)
    alphas = host(solver.iter_step_size)
    firsts = host(solver.iter_first_order)
    for i in range(costs.shape[0]):
        if not np.isfinite(costs[i]):
            break
        lines.append(
            "  iter {:2d}: cost = {:.6e}, |c|_inf = {:.3e}, lambda = {:.1e}, "
            "alpha = {:.4f}, |grad|_inf = {:.3e}".format(
                i, float(costs[i]), float(viols[i]), float(lams[i]),
                float(alphas[i]), float(firsts[i])))
    return "\n".join(lines)


class SolveLog:
    """Bounded ring buffer of solve logs (cap matches the web app's 5000,
    ``application.ts:431-434``), savable as one JSON document."""

    def __init__(self, capacity: int = 5000) -> None:
        self._buf: collections.deque = collections.deque(maxlen=capacity)

    def __len__(self) -> int:
        return len(self._buf)

    def append(self, outputs: Any) -> None:
        self._buf.append(solve_log_entry(outputs))

    def extend_batched(self, outputs: Any,
                       indices: Optional[Iterable[int]] = None):
        """Append entries from a batched ``MPCOutputs`` (leading batch
        axis)."""
        # Copy each leaf to the host ONCE, not once per appended entry.
        h = pytree.tree_map(host, outputs)
        n = h.u.shape[0]
        for i in indices if indices is not None else range(n):
            self.append(pytree.tree_map(lambda leaf: leaf[i], h))

    def entries(self) -> List[dict]:
        return list(self._buf)

    def to_json(self) -> str:
        return json.dumps(self.entries())

    def save(self, path: str) -> None:
        """Write ``log.json`` (the "Save log" button analog)."""
        with open(path, "w") as f:
            f.write(self.to_json())
