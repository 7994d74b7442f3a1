"""Host-side tracing with Chrome-trace JSON export, and device traces
through ``torch.profiler`` (counterpart of ``cartpole_tpu/utils/tracing.py``).

Parity surface: mini_opt's ``trace_collector`` singleton and its
``get_trace_json()`` Chrome-trace export, reached through the WASM bindings
``isTracingEnabled``/``getTraces`` (``optimization/wasm.cc:122-138``) and
saved by the web UI as ``traces.json`` (``viz/src/application.ts:353-364``).
The same switch as the JAX package's, ``CARTPOLE_TPU_TRACING``, turns it on.

:func:`trace_scope` times a host phase into the collector and also opens a
``torch.profiler.record_function`` of the same name, so the span appears in
a device trace taken by :func:`profiler_trace` around it. Spans are stamped
on the profiler's clock (the Unix epoch in ns, which ``torch.profiler``
converts its host and device timestamps to), so :func:`join_traces` lays
them over a ``trace.json`` of :func:`profiler_trace` as they happened. Each
span's args carry its ``id``, its ``parent`` (the innermost span open on
its thread) and its ``call`` (the span opened with ``call=True`` that it
runs in, such as ``lanes.call``, the whole of a closed-loop call).

Inside :func:`capture_marks`, a span opened while the current stream
captures a CUDA graph also records a timing event (``external``: an
event-record node of the graph) at its start and at its end, so that every
replay of the graph times the span on the card
(``mpc/closed_loop.py::CUDAGraphTick.phase_ms``). With tracing off no
event is recorded and the graph holds only the captured work.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Iterator, List, Optional

__all__ = [
    "TraceCollector",
    "trace_scope",
    "capture_marks",
    "get_trace_json",
    "is_tracing_enabled",
    "set_tracing_enabled",
    "profiler_trace",
    "join_traces",
]

_enabled = os.environ.get("CARTPOLE_TPU_TRACING", "") not in ("", "0", "false")

#: Per thread: ``stack``, the open spans as ``(id, call id)``; ``marks``,
#: the list :func:`capture_marks` fills, or None outside it.
_local = threading.local()


def is_tracing_enabled() -> bool:
    """WASM ``isTracingEnabled`` analog: a runtime switch (also set by the
    ``CARTPOLE_TPU_TRACING`` environment variable)."""
    return _enabled


def set_tracing_enabled(value: bool) -> None:
    global _enabled
    _enabled = bool(value)


class TraceCollector:
    """Process-wide collector of complete ('ph':'X') Chrome-trace events,
    kept in memory until exported. ``ts`` and ``dur`` are microseconds;
    ``ts`` counts from ``baseTimeNanoseconds`` of the export, a time on the
    profiler's clock."""

    _instance: Optional["TraceCollector"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._base_ns = time.time_ns()
        self._ids = itertools.count(1)

    @classmethod
    def get_instance(cls) -> "TraceCollector":
        """Singleton accessor (``trace_collector::get_instance`` analog)."""
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def next_id(self) -> int:
        """A span identifier, unique in the process."""
        return next(self._ids)

    def record(self, name: str, start_ns: int, end_ns: int, **args) -> None:
        """One span from ``start_ns`` to ``end_ns`` (``time.time_ns()``)."""
        event = {
            "name": name,
            "ph": "X",
            "ts": (start_ns - self._base_ns) / 1e3,
            "dur": (end_ns - start_ns) / 1e3,
            "pid": os.getpid(),
            "tid": threading.get_ident() & 0xFFFF,
        }
        if args:
            event["args"] = args
        with self._lock:
            self._events.append(event)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def get_trace_json(self) -> str:
        """Chrome ``chrome://tracing`` / Perfetto-loadable JSON."""
        with self._lock:
            return json.dumps({"traceEvents": list(self._events),
                               "baseTimeNanoseconds": self._base_ns})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.get_trace_json())


def get_trace_json() -> str:
    """Module-level convenience mirroring the WASM ``getTraces`` export
    (``""`` while tracing is off)."""
    if not _enabled:
        return ""
    return TraceCollector.get_instance().get_trace_json()


def _capturing() -> bool:
    import torch

    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


@contextlib.contextmanager
def trace_scope(name: str, call: bool = False, **args) -> Iterator[dict]:
    """Time a host-side phase into the collector, inside a
    ``torch.profiler.record_function`` of the same name (a no-op when
    tracing is off). ``call=True`` makes the span a call: it and every span
    opened inside it carry its id as ``call``. Yields the span's args:
    entries put there before it closes are recorded with it.

    Inside :func:`capture_marks`, while the current stream captures a CUDA
    graph, the span also records a timing event into the graph at its start
    and at its end (module docstring)."""
    if not _enabled:
        yield {}
        return
    import torch

    collector = TraceCollector.get_instance()
    stack = _local.__dict__.setdefault("stack", [])
    span_id = collector.next_id()
    parent, call_id = stack[-1] if stack else (None, None)
    if call:
        call_id = span_id
    args = dict(args, id=span_id, parent=parent, call=call_id)
    sink = getattr(_local, "marks", None)
    marks = None
    if sink is not None and _capturing():
        marks = tuple(torch.cuda.Event(enable_timing=True, external=True)
                      for _ in range(2))
        sink.append((name,) + marks)
    stack.append((span_id, call_id))
    start = time.time_ns()
    try:
        with torch.profiler.record_function(name):
            if marks:
                marks[0].record()
            yield args
            if marks:
                marks[1].record()
    finally:
        end = time.time_ns()
        stack.pop()
        collector.record(name, start, end, **args)


@contextlib.contextmanager
def capture_marks() -> Iterator[list]:
    """Yields a list that collects ``(name, start event, end event)`` for
    every span opened in this context while the current stream captures a
    CUDA graph (none while tracing is off). The events time each replay of
    the graph once it has run: ``start.elapsed_time(end)`` ms."""
    outer = getattr(_local, "marks", None)
    _local.marks = marks = []
    try:
        yield marks
    finally:
        _local.marks = outer


@contextlib.contextmanager
def profiler_trace(logdir: str) -> Iterator[object]:
    """Capture a ``torch.profiler`` trace of the CPU and, where there is
    one, the CUDA device, and export it as ``logdir/trace.json`` (Chrome
    trace format). Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def join_traces(profile: dict, spans: dict) -> dict:
    """A ``trace.json`` of :func:`profiler_trace` (parsed) with the
    collector's spans (a parsed :meth:`TraceCollector.get_trace_json`) laid
    over it on its time base, in a process row of their own named
    ``spans``."""
    shift = (spans.get("baseTimeNanoseconds", 0)
             - profile.get("baseTimeNanoseconds", 0)) / 1e3
    pid = "spans"
    events = [{"name": "process_name", "ph": "M", "pid": pid,
               "args": {"name": "spans"}}]
    events += [dict(e, ts=e["ts"] + shift, pid=pid)
               for e in spans["traceEvents"]]
    return dict(profile, traceEvents=profile["traceEvents"] + events)
