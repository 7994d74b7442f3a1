"""The traced call: one more call of the entry at the cell's shapes, with
the port's tracing on (``cartpole_tpu_torch/utils/tracing.py``), read by
the start-up and phase metrics (``metrics/startup.*``, ``metrics/tick.*``).

It runs after ``Driver.trace()``'s stretch, which runs with tracing off
and is left as it is. The call has ``2 + 1 + 2 * trace_ticks + 1`` ticks:
tick 0 eager, tick 1's warm-up, capture and instantiation, then replays.
The record keeps the call's spans and, for each of its replays 2 to
``trace_ticks + 1``, each synchronised, the graph's ``phase_ms()``: the
device milliseconds of each ``tick.*`` phase, from the timing events the
capture put into the graph. The next ``trace_ticks`` replays run under the
profiler, apart from those, since the profiler slows a replay down; the
record's ``breakdown`` becomes theirs: each device operation put down to
the phase whose events bracket it, each idle gap inside a replay labelled
by the phases on either side, and each gap between replays by the host
span open at it (the spans and the profile share one clock).

A reader is given the record alone: the driver that made it is found in
the caller's frame, beside it (``harness.run_cell``, ``readings.py``). The
call runs once a record, at its first reader. Off the card, or on a port
whose graph has no ``phase_ms``, nothing runs and the readers find
nothing.
"""

from __future__ import annotations

import collections
import json
import statistics
import sys

#: Where the traced call's readings go in the record.
KEY = "traced_call"

#: The first replay read, after those that follow the capture.
FIRST = 2

#: Entries of each list in the breakdown.
TOP = 10


def reading(record: dict) -> dict:
    """The traced call's readings for ``record`` (``{}`` where none): made
    on the first call, kept in the record."""
    if KEY not in record:
        driver = _driver_of(record)
        record[KEY] = {} if driver is None else traced_call(driver, record)
    return record[KEY]


def _driver_of(record):
    frame = sys._getframe(1)
    while frame is not None:
        local = frame.f_locals
        if local.get("record") is record and "driver" in local:
            return local["driver"]
        frame = frame.f_back
    return None


def span_s(record: dict, *names):
    """Seconds of the first span of each of ``names`` in the traced call,
    summed; None unless each is there."""
    spans = reading(record).get("spans", [])
    total = 0.0
    for name in names:
        durs = [e["dur"] for e in spans if e["name"] == name]
        if not durs:
            return None
        total += durs[0] * 1e-6
    return total


def median_ms(record: dict, phase: str):
    """Median over the read replays of ``phase``'s device ms; None where
    no replay has it."""
    values = [p[phase] for p in reading(record).get("phase_ms", [])
              if phase in p]
    return statistics.median(values) if values else None


def traced_call(driver, record: dict) -> dict:
    """Runs the traced call of ``driver``'s cell; puts its breakdown into
    ``record`` and returns ``{"spans", "phase_ms", "profiled_phase_ms"}``
    (the last from the profiled replays' marks)."""
    import torch

    from cartpole_tpu_torch.mpc import closed_loop
    from cartpole_tpu_torch.utils import tracing

    graph_type = closed_loop.CUDAGraphTick
    if driver.device.type != "cuda" or not hasattr(graph_type, "phase_ms"):
        return {}
    from torch.profiler import ProfilerActivity, profile

    n = driver.traffic["trace_ticks"]
    x0, dp, _, _ = driver._inputs(-1)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    read, offsets, seen = [], [], []
    replay = graph_type.__call__

    def read_replay(graph, *args):
        i = len(seen)
        seen.append(i)
        if i == FIRST + n:
            torch.cuda.synchronize()
            prof.start()
        out = replay(graph, *args)
        if FIRST <= i < FIRST + n:
            torch.cuda.synchronize()
            read.append(graph.phase_ms())
        elif FIRST + n <= i < FIRST + 2 * n:
            torch.cuda.synchronize()
            offsets.append(_offsets(graph.marks))
            if i == FIRST + 2 * n - 1:
                prof.stop()
        return out

    collector = tracing.TraceCollector.get_instance()
    traced = tracing.is_tracing_enabled()
    tracing.set_tracing_enabled(True)
    graph_type.__call__ = read_replay
    try:
        driver._sync()
        driver._call(x0, dp, 2 + 1 + 2 * n + 1)
        driver._sync()
    finally:
        graph_type.__call__ = replay
        tracing.set_tracing_enabled(traced)
    doc = json.loads(collector.get_trace_json())
    calls = [e for e in doc["traceEvents"] if e["name"] == "lanes.call"]
    call_id = calls[-1]["args"]["id"]
    spans = [e for e in doc["traceEvents"]
             if e.get("args", {}).get("call") == call_id]
    if len(offsets) == n and all(offsets):
        record["breakdown"] = breakdown(
            *profile_ops(prof), offsets, spans,
            doc.get("baseTimeNanoseconds", 0))
    return {"spans": spans, "phase_ms": read,
            "profiled_phase_ms": [{name: b - a for name, a, b in o}
                                  for o in offsets]}


def _offsets(marks) -> list:
    """``(phase, start ms, end ms)`` of each marked span in the last
    replay, counted back from the last mark (which follows the graph's
    last operation, while the first may precede its first operation by
    the graph's launch)."""
    last = marks[-1][2]
    return [(name, -s.elapsed_time(last), -e.elapsed_time(last))
            for name, s, e in marks]


def short(name: str) -> str:
    """A device operation's name without ``void `` and ``at::native::``."""
    return name.replace("void ", "").replace("at::native::", "")[:160]


def profile_ops(prof) -> tuple:
    """From a stopped profiler: the device operations ``(start ns, end
    ns, name, correlation)``, in order, and the launching host calls,
    ``{correlation: (name, start ns)}``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, launch = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and not e.is_user_annotation():
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.name(), e.correlation_id()))
        elif e.name().startswith("cuda"):
            launch[e.correlation_id()] = (e.name(), e.start_ns())
    return sorted(dev), launch


def breakdown(dev: list, launch: dict, offsets: list, spans: list,
              base_ns: int) -> dict:
    """The profiled replays' device seconds by phase and operation, and
    their idle gaps by phase (inside a replay) or by the open host span
    (between replays). ``dev`` and ``launch`` are :func:`profile_ops`';
    ``offsets`` holds each replay's :func:`_offsets` in turn; ``spans``
    the collector's events, their ``ts`` counted from ``base_ns``."""
    host = sorted((e["ts"] * 1e3, (e["ts"] + e["dur"]) * 1e3, e["name"])
                  for e in spans)

    def open_span(t):
        """The innermost span open at ``t`` ns, as a label."""
        t -= base_ns
        inner = [name for s, e, name in host if s <= t <= e]
        return "host " + (inner[-1] if inner else "none")

    # Each graph launch is one replay: its operations take the phases of
    # that replay's marks, counted back from the launch's last operation.
    ends = {}
    for _, t, _, c in dev:
        ends[c] = max(t, ends.get(c, t))
    graphs = sorted((c for c in ends if launch.get(c, ("",))[0]
                     .startswith("cudaGraphLaunch")),
                    key=lambda c: launch[c][1])
    marks = dict(zip(graphs, offsets))

    def phase_of(op):
        s, t, _, c = op
        if c not in marks:
            return None
        mid = ((s + t) / 2 - ends[c]) * 1e-6
        for name, a, b in marks[c]:
            if a <= mid <= b:
                return name.split(".", 1)[1]
        return "between"

    phases = [phase_of(op) for op in dev]
    by_name = collections.Counter()
    for op, ph in zip(dev, phases):
        where = ph or open_span(launch.get(op[3], ("", op[0]))[1])
        by_name[f"{where} {short(op[2])}"] += (op[1] - op[0]) * 1e-9
    gaps = collections.Counter()
    end, last = None, None
    for i, op in enumerate(dev):
        if end is not None and op[0] > end:
            a, b = phases[last], phases[i]
            if a and b and dev[last][3] == op[3]:
                label = f"replay {a}" if a == b else f"replay {a}->{b}"
            else:
                label = open_span((end + op[0]) / 2)
            gaps[label] += (op[0] - end) * 1e-9
        if end is None or op[1] > end:
            end, last = op[1], i
    return {"device_ops": [[k, v] for k, v in by_name.most_common(TOP)],
            "idle_gaps": [[k, v] for k, v in gaps.most_common(TOP)]}
