"""Analytic roofline: operations and bytes of a call against the card's
peaks (counterpart of ``cartpole_tpu/utils/roofline.py``).

The reference asks XLA's cost analysis for the FLOP and byte counts of a
compiled program (``xla_cost``). Eager torch has no compiled program to
ask, so :func:`op_cost` counts what a call dispatches (:class:`OpCounter`:
one operation per output element of an elementwise op, one per input
element of a reduction, 2mnk per matrix product) and the bytes its tensor
arguments and results move, each read or written once. :func:`bound` turns
the two into the least time the card could take; ``chip_smoke.py`` uses it
for each kernel's ``bound_ms``.

Peaks are NVIDIA's data-sheet numbers for the H100 SXM:
  HBM3          3.35 TB/s
  f32 (no tensor cores)  67 TFLOP/s
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpCounter", "count_ops", "bound", "op_cost", "roofline_row",
           "PEAK_BYTES", "PEAK_F32", "H100_PEAKS"]

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s off the
#: tensor cores.
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
H100_PEAKS = {"f32_vector_flops": PEAK_F32, "hbm_bytes": PEAK_BYTES}

_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "sin", "cos", "tanh",
    "sqrt", "rsqrt", "reciprocal", "pow", "maximum", "minimum", "clamp",
    "clamp_min", "clamp_max", "where", "remainder", "fmod", "gt", "lt", "ge",
    "le", "eq", "ne", "logical_and", "logical_or", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_not", "isfinite", "isnan", "exp",
    "log", "sign", "floor",
}
_REDUCTIONS = {"sum", "amax", "amin", "max", "min", "any", "all", "argmax",
               "mean"}


class OpCounter(TorchDispatchMode):
    """Arithmetic operations of a plain-version call, as torch dispatches
    them: one per output element of an elementwise op, one per input
    element of a reduction, 2mnk per matrix product. Copies, views and
    allocations count nothing."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name in ("mm", "addmm", "bmm"):
            a, b = (args[1], args[2]) if name == "addmm" else args[:2]
            self.ops += 2 * a.numel() * b.shape[-1]
        elif name in _REDUCTIONS:
            self.ops += args[0].numel()
        elif name in _ELEMENTWISE and isinstance(out, torch.Tensor):
            self.ops += out.numel()
        return out


def count_ops(fn) -> int:
    """Operations that ``fn()`` dispatches (:class:`OpCounter`)."""
    with OpCounter() as c:
        fn()
    return c.ops


def bound(n_bytes: float, n_ops: float):
    """Least time on the card (ms) for the work, and what bounds it."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _tensor_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def op_cost(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """``fn(*args, **kwargs)``'s ``flops`` (the operations it dispatches)
    and ``bytes accessed`` (its tensor arguments read once and its tensor
    results written once), the keys of the reference's ``xla_cost``."""
    with OpCounter() as c:
        out = fn(*args, **kwargs)
    return {"flops": float(c.ops),
            "bytes accessed": float(_tensor_bytes((args, kwargs))
                                    + _tensor_bytes(out))}


def roofline_row(name: str, cost: Dict[str, float], measured_s: float,
                 peaks: Dict[str, float] = H100_PEAKS) -> Dict[str, Any]:
    """One roofline table row: arithmetic intensity, compute/memory time
    bounds, and the utilization implied by a measured wall time."""
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    t_mem = nbytes / peaks["hbm_bytes"]
    t_f32 = flops / peaks["f32_vector_flops"]
    row = {
        "phase": name,
        "gflops": round(flops / 1e9, 3),
        "mbytes": round(nbytes / 1e6, 2),
        "arith_intensity": round(flops / nbytes, 2) if nbytes else None,
        "bound": "memory" if t_mem > t_f32 else "compute(f32)",
        "t_bound_ms": round(max(t_mem, t_f32) * 1e3, 3),
        "measured_ms": round(measured_s * 1e3, 3) if measured_s else None,
    }
    if measured_s:
        row["frac_of_roofline"] = round(max(t_mem, t_f32) / measured_s, 3)
        row["hbm_gbps_achieved"] = round(nbytes / measured_s / 1e9, 1)
    return row
