"""The numbers that decide ``correct``, shared by the drivers. Every
gap is between what the program produced and what the plain reference
computes from the same inputs, in float64 on the host.

* ``u_gap.<q>``: the ``q``-th percentile, over the checked solves, of the
  gap of a control over the mean magnitude of the reference's controls.
* ``x_gap.<q>``: the ``q``-th percentile of the gaps of every checked
  state (plant steps and predicted states together), the angles' gaps
  wrapped to (-pi, pi], in the states' own units.

Percentiles and not the largest gap: the f32 program decides a converged
solve's termination, or an Armijo test on its bound, on rounding noise, so
some solves of every run take another path than the float64 reference and
their gaps reach the size of the control's (``PERF.md``, section 2). Which
percentiles a cell compares, and their limits, are in its
``limits/<cell>.json``; the rest are printed beside them.
"""

from __future__ import annotations

import math

import numpy as np


def state_gap(a, b, angle_indices) -> np.ndarray:
    """Per-row largest gap of ``a - b`` over the last axis (states), the
    angles wrapped to (-pi, pi]."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    idx = list(angle_indices)
    d[..., idx] = np.mod(d[..., idx] + math.pi, 2 * math.pi) - math.pi
    d = np.abs(d)
    d[~np.isfinite(d)] = np.inf
    return d.max(axis=-1)


def u_gaps(u_prog, u_ref) -> np.ndarray:
    """Gaps of the program's controls over the mean magnitude of the
    reference's (non-finite gaps read inf)."""
    u_prog = np.asarray(u_prog, np.float64)
    u_ref = np.asarray(u_ref, np.float64)
    scale = np.mean(np.abs(u_ref))
    g = np.abs(u_prog - u_ref) / (scale if scale > 0 else 1.0)
    g[~np.isfinite(g)] = np.inf
    return g


def path_miss(code_prog, code_ref, iters_prog, iters_ref) -> float:
    """Share of solves whose code or iteration count differ."""
    miss = ((np.asarray(code_prog) != np.asarray(code_ref))
            | (np.asarray(iters_prog) != np.asarray(iters_ref)))
    return float(np.mean(miss)) if miss.size else 0.0


def _quantiles(prefix: str, gaps) -> dict:
    g = np.asarray(gaps, np.float64).ravel()
    if not g.size:
        return {}
    out = {f"{prefix}.p{q}": float(np.percentile(g, q))
           for q in (50, 90, 99)}
    out[f"{prefix}.max"] = float(np.max(g))
    return out


def summary(u, x_parts: dict, miss: float) -> dict:
    """Every number a check reads: the percentiles and the largest of the
    control gaps and of the state gaps (all parts pooled, and each part's
    90th percentile and largest as ``x_gap.<part>.p90`` and ``.max``),
    and the share of solves off the
    reference's path (``path_miss``)."""
    out = _quantiles("u_gap", u)
    out.update(_quantiles("x_gap", np.concatenate(
        [np.ravel(v) for v in x_parts.values()])))
    for k, v in x_parts.items():
        if np.size(v):
            out[f"x_gap.{k}.p90"] = float(np.percentile(v, 90))
            out[f"x_gap.{k}.max"] = float(np.max(v))
    out["path_miss"] = miss
    return out

