"""A short profiled stretch of the entry's own CUDA-graph replays, read
from the profiler's raw events.

:class:`ReplayProbe` profiles replays inside a real call of the entry: it
wraps ``torch.cuda.CUDAGraph.replay`` for the duration of the call, starts
the profiler at one replay and stops it at a later one, so what it reads
is the graph the entry built, replayed by the entry's own loop.

A replayed tick of the double pole is some 324k device operations, so the
events are read directly (``kineto_results.events()``) and never
aggregated by ``key_averages``, which takes minutes at that count (the
method of ``chip_smoke.py::profile_calls``).
"""

from __future__ import annotations

import collections
import time

import torch

#: Entries of each list in a result line's ``breakdown``.
TOP = 10


def _merge(intervals):
    """Union of ``(start, end, index)`` intervals sorted by start:
    ``[(start, end, first index, last index)]``."""
    out = []
    for s, e, i in intervals:
        if out and s <= out[-1][1]:
            last = out[-1]
            if e > last[1]:
                out[-1] = (last[0], e, last[2], i)
        else:
            out.append((s, e, i, i))
    return out


class ReplayProbe:
    """Profiles ``n`` replays of the CUDA graphs replayed while the probe
    is entered, after the first ``skip``: from the start of replay
    ``skip`` to the start of replay ``skip + n``, both ends synchronised,
    so each profiled tick holds one replay and the entry's work up to the
    next (its outputs cloned, the next inputs copied in). ``count()``, if
    given, is read at both ends (``counted``). The call has to replay at
    least ``skip + n + 1`` times; on the CPU nothing replays and
    :meth:`result` is empty."""

    def __init__(self, n: int, skip: int = 1, count=None):
        self.n, self.skip, self.count = n, skip, count
        self._prof = None
        self._seen = 0
        self._done = None

    def __enter__(self):
        self._orig = torch.cuda.CUDAGraph.replay
        probe = self

        def replay(graph):
            probe._before(probe._seen)
            probe._seen += 1
            return probe._orig(graph)

        torch.cuda.CUDAGraph.replay = replay
        return self

    def __exit__(self, *exc):
        torch.cuda.CUDAGraph.replay = self._orig
        if self._prof is not None:
            self._prof.stop()
            self._prof = None

    def _before(self, i: int):
        from torch.profiler import ProfilerActivity, profile

        if i == self.skip:
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.start()
            self._c0 = self.count() if self.count else 0
            torch.cuda.synchronize()
            self._t0 = time.perf_counter()
        elif i == self.skip + self.n and self._prof is not None:
            torch.cuda.synchronize()
            wall = time.perf_counter() - self._t0
            counted = (self.count() - self._c0) if self.count else 0
            self._prof.stop()
            self._done = (self._prof, wall, counted)
            self._prof = None

    def result(self) -> dict:
        """The profiled stretch (:func:`read`) and ``counted``; ``{}`` if
        the call replayed too few times."""
        if self._done is None:
            return {}
        prof, wall, counted = self._done
        return dict(read(prof, wall, self.n), counted=counted)


def read(prof, wall: float, n: int) -> dict:
    """The stretch of ``n`` ticks that ``prof`` traced in ``wall`` seconds:
    the seconds in which an operation ran on the device (the union of
    their intervals), the device operations, device seconds by operation
    name, and the idle gaps between operations by the host calls that
    launched the operations on either side of them."""
    events = prof.profiler.kineto_results.events()
    if events and hasattr(events[0], "duration_ns"):
        def span(e):
            return e.start_ns(), e.start_ns() + e.duration_ns()
    else:
        def span(e):
            s = e.start_us() * 1000
            return s, s + e.duration_us() * 1000
    cuda = torch.autograd.DeviceType.CUDA
    dev, api = [], {}
    for e in events:
        if e.device_type() == cuda:
            s, t = span(e)
            dev.append((s, t, e.name(), e.correlation_id()))
        elif e.name().startswith("cuda"):
            api[e.correlation_id()] = e.name()
    dev.sort()
    by_name = collections.Counter()
    for s, t, name, _ in dev:
        by_name[name] += (t - s) * 1e-9
    merged = _merge((s, t, i) for i, (s, t, _, _) in enumerate(dev))
    busy = sum(t - s for s, t, _, _ in merged) * 1e-9
    gaps = collections.Counter()
    for a, b in zip(merged, merged[1:]):
        prev, nxt = dev[a[3]], dev[b[2]]
        if prev[3] == nxt[3]:
            label = f"inside {api.get(nxt[3], 'unknown')}"
        else:
            label = (f"{api.get(prev[3], 'unknown')} -> "
                     f"{api.get(nxt[3], 'unknown')}")
        gaps[label] += (b[0] - a[1]) * 1e-9
    return {
        "calls": n,
        "window_s": wall,
        "busy_s": busy,
        "device_ops": len(dev),
        "device_s_by_name": dict(by_name),
        "breakdown": {
            "device_ops": [[k[:160], v] for k, v in by_name.most_common(TOP)],
            "idle_gaps": [[k, v] for k, v in gaps.most_common(TOP)],
        },
    }


def device_seconds(record: dict, fragment: str) -> float:
    """Device seconds of the operations whose name holds ``fragment``."""
    return sum(v for k, v in record.get("device_s_by_name", {}).items()
               if fragment in k)
