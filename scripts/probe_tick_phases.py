"""Card probe: a closed-loop call's start-up split and a replayed tick's
phase split against the clocks they should add up to, at a benchmark
cell's shapes (``portbench/``).

    python3 scripts/probe_tick_phases.py --workload single.fleet4k \
        --seed 5 --repeats 3

One process sets the cell up once, then for each repeat, with tracing off:
a synchronised 2-tick call of the entry (``call_startup_s`` as the
benchmark takes it), and a call in which ``trace_ticks`` replays after the
first two run between two synchronisations (the unprofiled replay time,
host clock over the replays divided by their count); then the traced call
of ``portbench/phases.py`` (start-up spans, against the 2-tick call and
against the traced call's own start, from ``lanes.call`` to its first
``lanes.replay``; each phase's device ms; the phase-labelled breakdown).
One JSON line a repeat on standard output, the card's name and power
limit last.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

STARTUP = ("lanes.eager_tick", "graph.warmup", "graph.capture",
           "graph.instantiate")


def unprofiled_replay_ms(driver, x0, dp, n: int) -> float:
    """Host ms over ``n`` replays of one call, after its first two,
    synchronised before the first and after the last, over ``n``."""
    import torch

    from cartpole_tpu_torch.mpc import closed_loop

    graph_type = closed_loop.CUDAGraphTick
    replay = graph_type.__call__
    seen, stamps = [], []

    def timed(graph, *args):
        i = len(seen)
        seen.append(i)
        if i == 2:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        out = replay(graph, *args)
        if i == 2 + n - 1:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        return out

    graph_type.__call__ = timed
    try:
        driver._call(x0, dp, 2 + 1 + n + 1)
        driver._sync()
    finally:
        graph_type.__call__ = replay
    return (stamps[1] - stamps[0]) * 1e3 / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)

    from portbench import harness, phases

    cell = harness.load_cell(args.workload)
    harness.require_chips(cell.chips)
    driver = harness.load_driver(cell).Driver(cell, args.seed, "cuda")
    driver.setup()
    n = driver.traffic["trace_ticks"]
    x0, dp, _, _ = driver._inputs(-1)
    for r in range(args.repeats):
        driver._sync()
        t0 = time.perf_counter()
        driver._call(x0, dp, 2)
        driver._sync()
        startup = time.perf_counter() - t0
        replay_ms = unprofiled_replay_ms(driver, x0, dp, n)
        record = {}
        readings = phases.traced_call(driver, record)
        spans = {name: phases.span_s({phases.KEY: readings}, name)
                 for name in STARTUP}
        call = next(e for e in readings["spans"] if e["name"] == "lanes.call")
        first = min(e["ts"] for e in readings["spans"]
                    if e["name"] == "lanes.replay")
        phase = {p: phases.median_ms({phases.KEY: readings}, p)
                 for p in readings["phase_ms"][0]}
        print(json.dumps({
            "cell": cell.name, "repeat": r, "call_startup_s": startup,
            "startup_spans_s": spans,
            "startup_sum_over_call": sum(spans.values()) / startup,
            "startup_sum_over_own": sum(spans.values()) * 1e6
            / (first - call["ts"]),
            "unprofiled_replay_ms": replay_ms, "phase_ms": phase,
            "phase_sum_over_replay": sum(phase.values()) / replay_ms,
            "profiled_phase_ms": readings["profiled_phase_ms"],
            "breakdown": record.get("breakdown")}), flush=True)
    print(f"card: {harness.power_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
