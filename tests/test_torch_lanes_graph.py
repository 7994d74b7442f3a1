"""The lanes closed loop's tick and its replay, on the CPU.

``mpc/lanes.py::run_closed_loop_lanes`` repeats ``tick_fn_lanes``; on the
card it runs tick 0 eagerly, takes tick 1 from the warm-up run of a
``CUDAGraphTick`` capture and replays the capture from tick 2. Here the
tick function run by hand must give the loop's bits (with and without
disturbances), and a stand-in for the graph, which replays by running the
tick eagerly, checks the loop's plumbing and the launch counts: a loop of
T ticks counts T launches of kernel 1 on path 1 and ``max_iterations * T``
of kernel 2 on path 2, whatever the capture counted. A capture that fails
raises.
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pt = pytest.importorskip("cartpole_tpu_torch")

from cartpole_tpu_torch.mpc import closed_loop as cl  # noqa: E402
from cartpole_tpu_torch.mpc import lanes  # noqa: E402
from cartpole_tpu_torch.ops import fused  # noqa: E402
from cartpole_tpu_torch.ops import pallas_kernels as pk  # noqa: E402
from cartpole_tpu_torch.utils import tracing  # noqa: E402

B, T = 3, 4
PARAMS = dict(window_length=6, state_spacing=2, max_iterations=3)


def _setup():
    mpc = pt.make_mpc(pt.OptimizationParams(**PARAMS))
    dp = pt.default_single_params(torch.float64, device="cpu")
    rng = np.random.RandomState(0)
    x0 = np.tile([0.0, -math.pi / 2, 0.0, 0.0], (B, 1))
    x0[:, :2] += rng.uniform(-0.3, 0.3, (B, 2))
    dist = np.zeros((B, T, 2, 2))
    dist[:, 1:3, 1, 0] = rng.uniform(2.0, 4.0, B)[:, None]
    return mpc, dp, torch.as_tensor(x0), torch.as_tensor(dist)


def _by_hand(mpc, dp, x0, fused_flag, dist=None):
    """The tick function, tick after tick."""
    sp = torch.zeros((B,), dtype=x0.dtype)
    tick = lanes.tick_fn_lanes(mpc, dp, sp, True, fused_flag)
    carry = (x0.T, torch.zeros((B, mpc.spec.dim), dtype=x0.dtype),
             torch.zeros((B,), dtype=torch.bool))
    rows = []
    for t in range(T):
        d = () if dist is None else (dist[:, t].permute(1, 2, 0),)
        out = tick(*carry, *d)
        rows.append(out[3:])
        carry = out[:3]
    return [torch.stack(c, dim=1) for c in zip(*rows)], carry


@pytest.mark.parametrize("fused_flag,disturbed", [
    (False, False), (True, False), (True, True)])
def test_loop_is_the_tick_function_repeated(fused_flag, disturbed):
    mpc, dp, x0, dist = _setup()
    d = dist if disturbed else None
    cols, carry = _by_hand(mpc, dp, x0, fused_flag, d)
    res = pt.run_closed_loop_lanes(mpc, x0, dp, T, disturbances=d,
                                   fused=fused_flag)
    names = ("states", "controls", "terminal_predictions",
             "termination_states", "constraint_violations",
             "solver_iterations")
    for name, col in zip(names, cols):
        assert torch.equal(getattr(res, name), col), name
    assert torch.equal(res.final_state, carry[0].T)
    assert torch.equal(res.final_mpc_state.previous_solution, carry[1])
    assert torch.equal(res.final_mpc_state.warm, carry[2])


class _StubGraphTick(cl.CUDAGraphTick):
    """``CUDAGraphTick`` on the CPU: the warm-up runs ``fn`` as the card's
    would; the capture runs it once too (the wrappers count its launches,
    as a capture's enqueues do), and a replay runs it again without
    counting, as a graph's replay runs no wrapper."""

    def _warm_up(self, fn, args):
        return fn(*args)

    def _capture(self, fn):
        self.outputs = fn(*self.inputs)

        def replay():
            before = cl.launch_counts()
            traced = tracing.is_tracing_enabled()
            tracing.set_tracing_enabled(False)  # a replay runs no host code
            try:
                for dst, src in zip(self.outputs, fn(*self.inputs)):
                    dst.copy_(src)
            finally:
                tracing.set_tracing_enabled(traced)
            cl.add_launches(tuple(
                a - b for a, b in zip(cl.launch_counts(), before)), -1)

        self.graph = type("Graph", (), {"replay": staticmethod(replay),
                                        "instantiate": lambda self: None})()
        return 0


def _counting(monkeypatch):
    """Kernel wrappers that count each call as the card's count a launch
    (on the CPU they run the plain versions and count nothing)."""

    def counted(fn, wrapper):
        def call(*a, **k):
            wrapper.launches += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(lanes, "fused_solve",
                        counted(fused.fused_solve, fused.fused_solve))
    monkeypatch.setattr(lanes, "segment_jac_batch_last",
                        counted(pk.segment_jac_batch_last,
                                pk.segment_jac_batch_last))
    monkeypatch.setattr(fused.fused_solve, "launches", 0)
    monkeypatch.setattr(pk.segment_jac_batch_last, "launches", 0)


@pytest.mark.parametrize("fused_flag", [True, False])
def test_replayed_loop_counts_one_tick_per_tick(monkeypatch, fused_flag):
    mpc, dp, x0, dist = _setup()
    eager = pt.run_closed_loop_lanes(mpc, x0, dp, T, disturbances=dist,
                                     fused=fused_flag)
    _counting(monkeypatch)
    made = []
    monkeypatch.setattr(lanes, "_replays", lambda x: True)
    monkeypatch.setattr(lanes, "CUDAGraphTick", lambda fn, args: made.append(
        _StubGraphTick(fn, args)) or made[-1])
    res = pt.run_closed_loop_lanes(mpc, x0, dp, T, disturbances=dist,
                                   fused=fused_flag)
    assert len(made) == 1
    n_iter = mpc.nls_config.max_iterations
    assert made[0].launches == ((1, 0) if fused_flag else (0, n_iter))
    want = (T, 0) if fused_flag else (0, n_iter * T)
    assert cl.launch_counts() == want
    for name in ("states", "controls", "termination_states",
                 "solver_iterations"):
        assert torch.equal(getattr(res, name), getattr(eager, name)), name


def test_a_failed_capture_raises(monkeypatch):
    mpc, dp, x0, _ = _setup()

    class Broken(_StubGraphTick):
        def _capture(self, fn):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    monkeypatch.setattr(lanes, "_replays", lambda x: True)
    monkeypatch.setattr(lanes, "CUDAGraphTick", Broken)
    with pytest.raises(RuntimeError, match="capturing"):
        pt.run_closed_loop_lanes(mpc, x0, dp, T, fused=True)


PHASES = ["tick.prepare", "tick.solve", "tick.evaluate", "tick.predict",
          "tick.plant"]


def _traced_run(monkeypatch, replayed, on=True):
    """A fused run of T ticks with tracing ``on``, eager or through the
    stand-in graph: its result and its spans in the order they opened."""
    mpc, dp, x0, dist = _setup()
    if replayed:
        monkeypatch.setattr(lanes, "_replays", lambda x: True)
        monkeypatch.setattr(lanes, "CUDAGraphTick", _StubGraphTick)
    collector = tracing.TraceCollector.get_instance()
    traced = tracing.is_tracing_enabled()
    tracing.set_tracing_enabled(on)
    try:
        collector.clear()
        res = pt.run_closed_loop_lanes(mpc, x0, dp, T, disturbances=dist,
                                       fused=True)
        events = json.loads(collector.get_trace_json())["traceEvents"]
    finally:
        tracing.set_tracing_enabled(traced)
    return res, sorted(events, key=lambda e: e["ts"])


@pytest.mark.parametrize("replayed", [False, True],
                         ids=["eager", "replayed"])
def test_spans_of_a_call(monkeypatch, replayed):
    """``lanes.call`` holds tick 0 eager, then (replayed) the graph's
    warm-up, capture and instantiation and a ``lanes.replay`` a tick, with
    no phase under a replay, which runs no host code; (eager) an eager tick
    a tick. Each eager run of the tick is its five phases in turn."""
    _, events = _traced_run(monkeypatch, replayed)
    if replayed:
        want = (["lanes.call", "lanes.eager_tick"] + PHASES
                + ["graph.warmup"] + PHASES + ["graph.capture"] + PHASES
                + ["graph.instantiate"] + ["lanes.replay"] * (T - 2))
    else:
        want = ["lanes.call"] + (["lanes.eager_tick"] + PHASES) * T
    assert [e["name"] for e in events] == want
    call = events[0]["args"]
    assert call["B"] == B and call["ticks"] == T and call["fused"] is True
    assert call["parent"] is None and call["call"] == call["id"]
    holder = None
    for e in events[1:]:
        a = e["args"]
        assert a["call"] == call["id"]
        if e["name"].startswith("tick."):
            assert a["parent"] == holder["args"]["id"]
            assert holder["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= holder["ts"] + holder["dur"] + 1
        else:
            assert a["parent"] == call["id"]
            holder = e
    ticks = [e["args"]["tick"] for e in events
             if e["name"] in ("lanes.eager_tick", "lanes.replay")]
    assert ticks == ([0, 2, 3] if replayed else list(range(T)))
    if replayed:
        (capture,) = [e for e in events if e["name"] == "graph.capture"]
        assert capture["args"]["pool_bytes"] == 0


@pytest.mark.parametrize("replayed", [False, True],
                         ids=["eager", "replayed"])
def test_tracing_off_records_nothing_and_changes_no_bit(monkeypatch,
                                                        replayed):
    on, spans = _traced_run(monkeypatch, replayed)
    off, none = _traced_run(monkeypatch, replayed, on=False)
    assert spans and none == []
    for name in on._fields:
        a, b = getattr(on, name), getattr(off, name)
        for x, y in zip(a if name == "final_mpc_state" else (a,),
                        b if name == "final_mpc_state" else (b,)):
            assert torch.equal(x, y), name
