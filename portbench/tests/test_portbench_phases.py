"""The traced call's readers (``phases.py``, ``metrics/startup.*``,
``metrics/tick.*``) on made-up records and profiles; on the card
(``-m chip``): a graph's phase events against the device time they
bracket, the spans' clock against the profiler's, and a traced run of a
tiny cell."""

import json
import statistics
import time

import pytest

from conftest import tiny
from portbench import harness, phases

STARTUP = {"startup.eager_s": ("lanes.eager_tick", "graph.warmup"),
           "startup.capture_s": ("graph.capture",),
           "startup.instantiate_s": ("graph.instantiate",)}
PHASES = ["prepare", "solve", "evaluate", "predict", "plant"]
METRICS = list(STARTUP) + [f"tick.{p}_ms" for p in PHASES]


def _record():
    """A traced call's readings as ``phases.traced_call`` keeps them: a
    second eager tick, which the start-up leaves out, and three replays."""
    spans = [{"name": n, "dur": d} for n, d in (
        ("lanes.call", 9e6), ("lanes.eager_tick", 1.5e6),
        ("graph.warmup", 1.25e6), ("graph.capture", 0.5e6),
        ("graph.instantiate", 0.25e6), ("lanes.eager_tick", 7e6))]
    replays = [{f"tick.{p}": 1.0 + i + k for k, p in enumerate(PHASES)}
               for i in (0.0, 2.0, 0.5)]
    return {phases.KEY: {"spans": spans, "phase_ms": replays}}


@pytest.mark.parametrize("name", METRICS)
def test_reader_on_a_record_without_its_fields(name):
    read = harness.load_reader(name)
    assert read({}) is None
    assert read({phases.KEY: {}}) is None
    assert read({"driver": "lanes_fleet", "ticks": 3,
                 "call_startup_s": 2.0}) is None


@pytest.mark.parametrize("name", METRICS)
def test_reader_on_a_made_up_record(name):
    value = harness.load_reader(name)(_record())
    if name in STARTUP:
        want = {"startup.eager_s": 2.75, "startup.capture_s": 0.5,
                "startup.instantiate_s": 0.25}[name]
    else:
        k = PHASES.index(name[len("tick."):-len("_ms")])
        want = statistics.median([1.0 + i + k for i in (0.0, 2.0, 0.5)])
    assert value == pytest.approx(want)


def test_breakdown_labels_by_phase_and_host_span():
    """Two replays: every operation and every gap inside a replay takes
    its phase (or the two on either side), and the gaps between replays
    the host span open."""
    us = 1000
    launch = {1: ("cudaMemcpyAsync", 0), 2: ("cudaGraphLaunch", 5 * us),
              3: ("cudaGraphLaunch", 60 * us)}
    dev = [(2 * us, 3 * us, "Memcpy DtoD", 1),
           (10 * us, 14 * us, "void at::native::k_prep<float>", 2),
           (16 * us, 20 * us, "void fused_iteration_kernel<float>", 2),
           (20 * us, 22 * us, "void at::native::k_plant<float>", 2),
           (70 * us, 74 * us, "void at::native::k_prep<float>", 3),
           (74 * us, 80 * us, "void fused_iteration_kernel<float>", 3),
           (81 * us, 83 * us, "void at::native::k_plant<float>", 3)]
    # Each replay's marks in ms, counted back from its last operation's
    # end; the first opens before the first operation.
    first = [("tick.prepare", -0.0125, -0.0065),
             ("tick.solve", -0.0065, -0.0015), ("tick.plant", -0.0015, 0.0)]
    second = [("tick.prepare", -0.0135, -0.0085),
              ("tick.solve", -0.0085, -0.002), ("tick.plant", -0.002, 0.0)]
    base = 500 * us  # the spans' ts count (in us) from here
    spans = [{"name": "lanes.call", "ts": -501.0, "dur": 200.0},
             {"name": "lanes.replay", "ts": -500.0, "dur": 25.0},
             {"name": "lanes.replay", "ts": -445.0, "dur": 30.0}]
    out = phases.breakdown(dev, launch, [first, second], spans, base)
    ops = dict(out["device_ops"])
    assert ops["solve fused_iteration_kernel<float>"] == pytest.approx(10e-6)
    assert ops["prepare k_prep<float>"] == pytest.approx(8e-6)
    assert ops["plant k_plant<float>"] == pytest.approx(4e-6)
    assert ops["host lanes.replay Memcpy DtoD"] == pytest.approx(1e-6)
    gaps = dict(out["idle_gaps"])
    assert gaps["replay prepare->solve"] == pytest.approx(2e-6)
    assert gaps["replay solve->plant"] == pytest.approx(1e-6)
    assert gaps["host lanes.replay"] == pytest.approx(7e-6)
    assert gaps["host lanes.call"] == pytest.approx(48e-6)
    assert not any(k.startswith("inside") for k in gaps)


@pytest.mark.chip
def test_phase_events_time_the_graph_on_the_card(card):
    """Two spans under a capture, each around a spin kernel of known
    length: ``phase_ms`` of a replay reads each, and their sum the replay's
    device time taken by events outside the graph."""
    import torch

    from cartpole_tpu_torch.mpc.closed_loop import CUDAGraphTick
    from cartpole_tpu_torch.utils import tracing

    def fn(x):
        with tracing.trace_scope("tick.short"):
            torch.cuda._sleep(1_000_000)
            y = x + 1
        with tracing.trace_scope("tick.long"):
            torch.cuda._sleep(3_000_000)
            y = y * 2
        return (y,)

    x = torch.zeros(8, device=card)
    traced = tracing.is_tracing_enabled()
    try:
        tracing.set_tracing_enabled(False)
        assert CUDAGraphTick(fn, (x,)).phase_ms() == {}
        tracing.set_tracing_enabled(True)
        graph = CUDAGraphTick(fn, (x,))
    finally:
        tracing.set_tracing_enabled(traced)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(3):
        a.record()
        graph.graph.replay()
        b.record()
        b.synchronize()
        ms = graph.phase_ms()
        outside = a.elapsed_time(b)
        assert set(ms) == {"tick.short", "tick.long"}
        assert 2.5 < ms["tick.long"] / ms["tick.short"] < 3.5
        assert 0.9 * outside < ms["tick.short"] + ms["tick.long"] <= outside


@pytest.mark.chip
def test_a_span_brackets_its_kernel_on_the_joined_clock(card, tmp_path):
    import torch

    from cartpole_tpu_torch.utils import tracing

    traced = tracing.is_tracing_enabled()
    tracing.set_tracing_enabled(True)
    try:
        tracing.TraceCollector.get_instance().clear()
        with tracing.profiler_trace(str(tmp_path)):
            torch.cuda.synchronize()
            with tracing.trace_scope("around"):
                torch.cuda._sleep(2_000_000)
                torch.cuda.synchronize()
        spans = json.loads(tracing.get_trace_json())
    finally:
        tracing.set_tracing_enabled(traced)
    joined = tracing.join_traces(
        json.loads((tmp_path / "trace.json").read_text()), spans)
    (span,) = [e for e in joined["traceEvents"]
               if e["name"] == "around" and e.get("pid") == "spans"]
    (kernel,) = [e for e in joined["traceEvents"]
                 if "spin_kernel" in e["name"] and e.get("ph") == "X"]
    assert span["ts"] <= kernel["ts"]
    assert kernel["ts"] + kernel["dur"] <= span["ts"] + span["dur"]


@pytest.mark.chip
def test_traced_run_reports_the_phases(card):
    cell = harness.load_cell("single.fleet4k")
    out = harness.run_cell(cell, 2**31 + 7, 0.01, True, card,
                           time.monotonic(), tiny("single.fleet4k",
                                                  "float32"))
    for name in METRICS:
        assert out["metrics"][name]["value"] > 0, name
    gaps = [k for k, _ in out["breakdown"]["idle_gaps"]]
    assert any(k.startswith("replay ") for k in gaps)
    assert not any(k.startswith("inside") for k in gaps)
