"""Debug mode: the sanitizer / ``F_ASSERT`` story for a torch program
(counterpart of ``cartpole_tpu/utils/debug.py``).

The reference controller guards every boundary with ``F_ASSERT_*``
(``optimization.cc:14-21``, ``simulator.cc:13-14``) and runs sanitizer
builds in CI. On the card a NaN does not trap: it propagates, and the
production solver deliberately *masks* non-finite instances instead of
stopping (``MPC.failure_mask``). This module is the opt-in tool for when
you want to STOP and see where a bad value was born:

* :func:`debug_mode`: the counterpart of ``jax_debug_nans`` /
  ``jax_debug_infs``. Inside the scope every torch operation's floating
  output is checked, and the first NaN (or Inf) raises
  ``FloatingPointError`` naming the operation that made it; autograd's
  anomaly detection is on too, for the backward. Each check reads a value
  back to the host: use it on small repros, not on the bench loop.
* :func:`checked`: wraps a function; the wrapper raises
  :class:`DebugCheckError` with the tree path of the first non-finite
  output.
* :func:`assert_all_finite`: the ``F_ASSERT(std::isfinite(u))`` analog for
  whole trees (states, warm starts, checkpoints), reporting the path of
  every offending leaf.
* :func:`leak_check`: live tensors, the ``doLeakCheck`` analog.

None of this runs in production paths.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import warnings
from typing import Any, Callable, Iterator, Optional

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "DebugCheckError",
    "assert_all_finite",
    "checked",
    "debug_mode",
    "leak_check",
]


class DebugCheckError(AssertionError):
    """A finite-value assertion failed."""


class _NonFiniteCheck(TorchDispatchMode):
    """Raise at the first operation whose floating output holds a NaN (or,
    with ``infs``, an Inf)."""

    def __init__(self, nans: bool, infs: bool):
        super().__init__()
        self.nans, self.infs = nans, infs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if not (isinstance(t, torch.Tensor) and t.is_floating_point()):
                continue
            if self.nans and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN produced by {func}")
            if self.infs and bool(torch.isinf(t).any()):
                raise FloatingPointError(f"Inf produced by {func}")
        return out


@contextlib.contextmanager
def debug_mode(nans: bool = True, infs: bool = True) -> Iterator[None]:
    """Check every operation inside the scope for NaN (and Inf with
    ``infs``) outputs, raising ``FloatingPointError`` at the first, with
    autograd's anomaly detection on; both are restored on exit, on an
    exception too."""
    anomaly = torch.is_anomaly_enabled()
    anomaly_nan = torch.is_anomaly_check_nan_enabled()
    torch.autograd.set_detect_anomaly(True, check_nan=bool(nans))
    try:
        with _NonFiniteCheck(bool(nans), bool(infs)):
            yield
    finally:
        torch.autograd.set_detect_anomaly(anomaly, check_nan=anomaly_nan)


def _leaves_with_paths(tree: Any):
    leaves, spec = pytree.tree_flatten_with_path(tree)
    return [(pytree.keystr(p), leaf) for p, leaf in leaves]


def _first_bad(tree: Any) -> Optional[str]:
    for path, leaf in _leaves_with_paths(tree):
        if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                and not bool(torch.isfinite(leaf).all())):
            return path
    return None


def checked(fn: Callable[..., Any]) -> Callable[..., Any]:
    """Wrap ``fn``: the wrapper returns ``fn``'s outputs, or raises
    :class:`DebugCheckError` naming the tree path of its first non-finite
    output (``""`` for a bare tensor)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        bad = _first_bad(out)
        if bad is not None:
            raise DebugCheckError(
                f"non-finite (nan or inf) output of "
                f"{getattr(fn, '__name__', 'fn')} at 'out{bad}'")
        return out

    return wrapper


def assert_all_finite(tree: Any, name: str = "tree") -> None:
    """Host-side ``F_ASSERT(isfinite(...))`` over every floating leaf of a
    tree; raises :class:`DebugCheckError` listing the path, dtype, shape
    and count of bad entries of every offending leaf."""
    bad = []
    for path, leaf in _leaves_with_paths(tree):
        t = torch.as_tensor(leaf)
        if not t.is_floating_point():
            continue
        n_bad = int((~torch.isfinite(t)).sum())
        if n_bad:
            bad.append(f"  {name}{path}: {n_bad}/{t.numel()} non-finite "
                       f"({t.dtype}, shape {tuple(t.shape)})")
    if bad:
        raise DebugCheckError(f"non-finite values in '{name}':\n"
                              + "\n".join(bad))


def _shape_key(t: torch.Tensor) -> str:
    return f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"


def leak_check(baseline=None, device: Optional[str] = None) -> dict:
    """Report live tensors: the ``doLeakCheck`` analog.

    The torch equivalent of "leaked objects" is tensors kept alive by
    stray references (a logging list holding whole batched outputs, a
    closure pinning a sweep's warm starts). Returns ``{"count", "nbytes",
    "by_shape"}`` for the live tensors that ``gc`` sees on ``device``'s
    type (default: CUDA when there is a card, else the CPU), and on CUDA
    also ``"allocated"``, ``torch.cuda.memory_allocated()``. ``baseline``
    may be a previous report (every number, per-shape counts included, is
    then a delta beyond it, so a leak-free loop after a heavy setup reads
    as zeros) or a bare int (a count to subtract).
    """
    kind = device or ("cuda" if torch.cuda.is_available() else "cpu")
    kind = torch.device(kind).type
    seen, tensors = set(), []
    with warnings.catch_warnings():
        # isinstance() on some module proxies warns of their deprecation.
        warnings.simplefilter("ignore")
        for obj in gc.get_objects():
            try:
                if (isinstance(obj, torch.Tensor) and obj.device.type == kind
                        and id(obj) not in seen):
                    seen.add(id(obj))
                    tensors.append(obj)
            except Exception:  # noqa: BLE001 - objects failing isinstance
                continue
    by_shape: dict = {}
    for t in tensors:
        key = _shape_key(t)
        by_shape[key] = by_shape.get(key, 0) + 1
    nbytes = int(sum(t.element_size() * t.numel() for t in tensors))
    count = len(tensors)
    report = {}
    if kind == "cuda":
        report["allocated"] = int(torch.cuda.memory_allocated())
    if isinstance(baseline, dict):
        count -= baseline.get("count", 0)
        nbytes -= baseline.get("nbytes", 0)
        for key, n in baseline.get("by_shape", {}).items():
            by_shape[key] = by_shape.get(key, 0) - n
        by_shape = {k: v for k, v in by_shape.items() if v > 0}
        if "allocated" in report:
            report["allocated"] -= baseline.get("allocated", 0)
    elif baseline:
        count -= int(baseline)
    return {
        "count": max(0, count),
        "nbytes": max(0, nbytes),
        "by_shape": dict(sorted(by_shape.items(), key=lambda kv: -kv[1])[:20]),
        **report,
    }
