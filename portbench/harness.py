"""What every cell shares: finding the cell's files by name, the chip
check, the guard against JAX, the per-layer readers, the correctness
verdict and the result line."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: Top-level module names that may not be loaded in a run: JAX and the JAX
#: package the port was made from. Compared whole, since the port's own
#: name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "cartpole_tpu")


@dataclasses.dataclass
class Cell:
    """One entry of ``BENCHMARK.json``'s ``workloads`` with its files."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def merge(base: dict, over: dict) -> dict:
    """``base`` with the entries of ``over``, nested dicts merged."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: str | None = None) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json`` at the root of
    the checkout): its configuration, traffic mix and limits read from
    ``configs/``, ``traffic/`` and ``limits/``, and the metrics it
    reports."""
    spec = _json(bench or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = _json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    limits = _json(os.path.join(HERE, "limits", name + ".json"))

    def reported(metric):
        return "workloads" not in metric or name in metric["workloads"]

    e2e = [m for m in spec["end_to_end"] if reported(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if name in m.get("workloads", ())
                 or ("workloads" not in m and m["moves"] in names)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e,
                per_layer)


def require_chips(chips: int) -> None:
    """Exit without a result unless the card is there, ``chips`` of it."""
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        raise SystemExit(2)
    if torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} cards, {torch.cuda.device_count()} "
              "are visible", file=sys.stderr)
        raise SystemExit(2)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is in :data:`FORBIDDEN`."""
    return sorted({k for k in list(sys.modules)
                   if k.split(".")[0] in FORBIDDEN})


def guard() -> None:
    """Exit without a result if JAX or the JAX package has been loaded."""
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        raise SystemExit(3)


def load_driver(cell: Cell):
    """The driver module the cell's traffic names (``drivers/<name>.py``)."""
    return importlib.import_module("portbench.drivers." + cell.traffic[
        "driver"])


def load_reader(metric_name: str):
    """``read(trace) -> float | None`` of ``metrics/<metric_name>.py``."""
    path = os.path.join(HERE, "metrics", metric_name + ".py")
    mod_name = "portbench_metric_" + metric_name.replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def verdict(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every limit has a finite number at or under
    it; ``checks`` pairs each number with its limit."""
    checks = {}
    ok = bool(limits)
    for name, limit in limits.items():
        value = numbers.get(name)
        good = (value is not None and math.isfinite(value)
                and value <= limit)
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def power_line() -> str:
    """The card's name, power limit, SM clock (now and its maximum) and
    temperature, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float, overrides: dict | None = None) -> dict:
    """Set up, measure for ``seconds``, read the trace (``trace``), check
    against the reference, and return the result line's object (without
    printing it). ``device`` is ``"cuda"`` in a run; the tests pass
    ``"cpu"``, which the command itself never does."""
    import torch

    driver = load_driver(cell).Driver(cell, seed, device, overrides)
    driver.setup()
    setup_s = time.monotonic() - t0
    e2e = driver.window(seconds)
    guard()
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    result_device = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    metrics = {}
    breakdown = None
    if trace:
        record = driver.trace()
        for m in cell.per_layer:
            value = load_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result_device["busy_s"] = record.get("busy_s", 0.0)
        result_device["window_s"] = record.get("window_s", 0.0)
        breakdown = record.get("breakdown")
    else:
        values = dict(e2e["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    if on_card:
        print(f"card: {power_line()}", file=sys.stderr)
    numbers = driver.check()
    print("gaps: " + json.dumps(numbers), file=sys.stderr)
    guard()
    correct, checks = verdict(numbers, cell.limits["limits"])
    out = {"correct": correct, "attempted": e2e["attempted"],
           "failed": e2e["failed"], "metrics": metrics,
           "device": result_device}
    if breakdown:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def print_result(out: dict) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, then the result as the last line of standard output."""
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
