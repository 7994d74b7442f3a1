"""Host-side tracing with Chrome-trace JSON export, and device traces
through ``torch.profiler`` (counterpart of ``cartpole_tpu/utils/tracing.py``).

Parity surface: mini_opt's ``trace_collector`` singleton and its
``get_trace_json()`` Chrome-trace export, reached through the WASM bindings
``isTracingEnabled``/``getTraces`` (``optimization/wasm.cc:122-138``) and
saved by the web UI as ``traces.json`` (``viz/src/application.ts:353-364``).
The same switch as the JAX package's, ``CARTPOLE_TPU_TRACING``, turns it on.
:func:`trace_scope` times a host phase into the collector and also opens a
``torch.profiler.record_function`` of the same name, so the span appears in
a device trace taken by :func:`profiler_trace` around it.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Iterator, List, Optional

__all__ = [
    "TraceCollector",
    "trace_scope",
    "get_trace_json",
    "is_tracing_enabled",
    "set_tracing_enabled",
    "profiler_trace",
]

_enabled = os.environ.get("CARTPOLE_TPU_TRACING", "") not in ("", "0", "false")


def is_tracing_enabled() -> bool:
    """WASM ``isTracingEnabled`` analog: a runtime switch (also set by the
    ``CARTPOLE_TPU_TRACING`` environment variable)."""
    return _enabled


def set_tracing_enabled(value: bool) -> None:
    global _enabled
    _enabled = bool(value)


class TraceCollector:
    """Process-wide collector of complete ('ph':'X') Chrome-trace events."""

    _instance: Optional["TraceCollector"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._t0_us = time.perf_counter_ns() // 1000

    @classmethod
    def get_instance(cls) -> "TraceCollector":
        """Singleton accessor (``trace_collector::get_instance`` analog)."""
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def record(self, name: str, start_us: int, dur_us: int, **args) -> None:
        event = {
            "name": name,
            "ph": "X",
            "ts": start_us - self._t0_us,
            "dur": dur_us,
            "pid": os.getpid(),
            "tid": threading.get_ident() & 0xFFFF,
        }
        if args:
            event["args"] = args
        with self._lock:
            self._events.append(event)

    def record_at(self, name: str, ts_us: int, dur_us: int, **args) -> None:
        """Record with an explicit timeline offset (ts starting at 0)."""
        self.record(name, self._t0_us + ts_us, dur_us, **args)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def get_trace_json(self) -> str:
        """Chrome ``chrome://tracing`` / Perfetto-loadable JSON."""
        with self._lock:
            return json.dumps({"traceEvents": list(self._events)})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.get_trace_json())


def get_trace_json() -> str:
    """Module-level convenience mirroring the WASM ``getTraces`` export
    (``""`` while tracing is off)."""
    if not _enabled:
        return ""
    return TraceCollector.get_instance().get_trace_json()


@contextlib.contextmanager
def trace_scope(name: str, **args) -> Iterator[None]:
    """Time a host-side phase into the collector, inside a
    ``torch.profiler.record_function`` of the same name (a no-op when
    tracing is off)."""
    if not _enabled:
        yield
        return
    import torch

    start = time.perf_counter_ns() // 1000
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        end = time.perf_counter_ns() // 1000
        TraceCollector.get_instance().record(name, start, end - start, **args)


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
