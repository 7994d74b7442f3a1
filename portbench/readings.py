"""The readings the correctness limits are set from, on the card.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--traces N]

One process sets the cell up once, then for each of ``--seeds`` runs one
episode of the window, and for each of ``--control-seeds`` the control
(``control.py``) at the cell's own batch, keeping the plants a run would
keep. The float64 reference then follows all of them in one chain, as a
run's check follows its own (the plants are independent, so each reads as
in a run of its own), and each seed's numbers are one JSON line on
standard output: ``{"cell", "seed", "kind": "program" | "control",
"numbers"}``. ``--traces N`` then reads the traced stretch ``N`` times and
prints its per-layer metrics. The benchmark's own runs never run this.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] == os.path.dirname(os.path.abspath(__file__)):
    sys.path.pop(0)
sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--traces", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import control, harness
    from portbench.drivers import lanes_fleet

    cell = harness.load_cell(args.workload)
    harness.require_chips(cell.chips)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    driver = harness.load_driver(cell).Driver(cell, seeds[0] if seeds else 0,
                                              "cuda")
    driver.setup()

    def emit(**fields):
        print(json.dumps({"cell": cell.name, **fields}), flush=True)

    kept, info = [], []
    for seed in seeds:
        driver.seed = seed
        window = driver.window(0.0)
        kept.append(lanes_fleet.concat(driver.records))
        driver.records = []
        info.append(("program", seed, window))
    for seed in cseeds:
        t0 = time.perf_counter()
        kept.append(control.control_record(driver.config, driver.traffic,
                                           driver.spec, seed))
        info.append(("control", seed, {"seconds": time.perf_counter() - t0}))
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec = lanes_fleet.concat(kept)
    chain = lanes_fleet.reference_chain(driver.config, rec["states"],
                                        rec["grid"], torch.float64, "cuda")
    emit(chain_s=time.perf_counter() - t0, plants=len(rec["states"]))
    for (kind, seed, extra), r, ch in zip(
            info, kept, lanes_fleet.split(chain, [len(r["states"])
                                                  for r in kept])):
        numbers = lanes_fleet.fleet_numbers(driver.config, r,
                                            driver.spec["start_ticks"], ch)
        ok, _ = harness.verdict(numbers, cell.limits["limits"])
        emit(seed=seed, kind=kind, numbers=numbers, correct=ok, extra=extra)
    for _ in range(args.traces):
        record = driver.trace()
        emit(trace={m["name"]: harness.load_reader(m["name"])(record)
                    for m in cell.per_layer},
             busy_s=record.get("busy_s"), window_s=record.get("window_s"),
             breakdown=record.get("breakdown"))
    print(f"card: {harness.power_line()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
