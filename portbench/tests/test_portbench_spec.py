"""``BENCHMARK.json`` against the benchmark's contract, and every file a
cell is found by."""

import json
import os
import re

import pytest

from conftest import ROOT

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PB = os.path.join(ROOT, "portbench")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_are_unique_and_well_formed(group):
    names = [e["name"] for e in SPEC[group]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert 1 <= len(metric["layer"]) <= 200
        e2e = {m["name"]: m for m in SPEC["end_to_end"]}
        moved = e2e[metric["moves"]]
        assert set(metric["workloads"]) <= set(moved.get("workloads",
                                                         cells))
        assert os.path.exists(os.path.join(PB, "metrics",
                                           metric["name"] + ".py"))
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_every_cell_reports_what_the_contract_asks():
    e2e, per_layer = SPEC["end_to_end"], SPEC["per_layer"]
    assert "setup_s" in {m["name"] for m in e2e}
    for w in SPEC["workloads"]:
        mine = [m for m in e2e if w["name"] in m.get("workloads",
                                                      [w["name"]])]
        assert len(mine) >= 2 and "setup_s" in {m["name"] for m in mine}
        assert any(w["name"] in m["workloads"] for m in per_layer)


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    assert NAME.match(cell["traffic"]) and NAME.match(cell["config"])
    assert cell["config"] in {c["name"] for c in SPEC["configs"]}
    traffic = json.load(open(os.path.join(PB, "traffic",
                                          cell["traffic"] + ".json")))
    assert os.path.exists(os.path.join(PB, "drivers",
                                       traffic["driver"] + ".py"))
    limits = json.load(open(os.path.join(PB, "limits",
                                         cell["name"] + ".json")))
    # Percentiles of gaps, or the largest of the plants' median gaps over
    # their episodes: never the largest single gap, which f32 rounding
    # swings (PERF.md).
    assert limits["limits"] and all(
        re.match(r"^([ux]_gap(\.[a-z]+)?\.p(50|90|99)|u_gap\.episode\.max)$",
                 k) for k in limits["limits"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("portbench/")
    body = json.load(open(os.path.join(ROOT, config["file"])))
    assert body["name"] == config["name"]
    assert config["reduced"] == []
    for key in ("model", "dtype", "optimization", "dynamics", "assumed"):
        assert key in body
    assert 1 <= len(config["source"]) <= 200


def test_only_four_chip_cells_where_allowed():
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)
