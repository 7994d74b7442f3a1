"""A later change adds a configuration, a traffic mix, a per-layer metric
and a cell by adding files and entries alone: a copy of the benchmark
with only such additions runs the new cell, and reports the new metric,
without an edit to any file that was there."""

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT


def test_new_cell_from_files_alone(tmp_path):
    pb = tmp_path / "portbench"
    shutil.copytree(os.path.join(ROOT, "portbench"), pb,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {os.path.join(dp, p): open(os.path.join(dp, p), "rb").read()
              for dp, _, fs in os.walk(pb) for p in fs}
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))

    config = json.load(open(pb / "configs" / "single.json"))
    config.update(name="single_short",
                  optimization=dict(config["optimization"],
                                    window_length=20))
    json.dump(config, open(pb / "configs" / "single_short.json", "w"))
    mix = json.load(open(pb / "traffic" / "swingup4k.json"))
    mix.update(batch=5, episode_ticks=4, warm_ticks=2, trace_ticks=2,
               start={"center": "upright", "half_width": [0.2, 0.1]})
    json.dump(mix, open(pb / "traffic" / "upright_few.json", "w"))
    limits = json.load(open(pb / "limits" / "single.fleet4k.json"))
    limits.update(sample_per_episode=3, start_ticks=2)
    json.dump(limits, open(pb / "limits" / "single_short.upright_few.json",
                           "w"))
    (pb / "metrics" / "replays_traced.py").write_text(
        "def read(record):\n    return float(record['ticks'])\n")

    spec["configs"].append(dict(spec["configs"][0], name="single_short",
                                file="portbench/configs/single_short.json"))
    spec["workloads"].append({"name": "single_short.upright_few",
                              "config": "single_short",
                              "traffic": "upright_few", "chips": 1,
                              "why": "a throwaway cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "solves_per_s":
            m["workloads"].append("single_short.upright_few")
    spec["per_layer"].append({"name": "replays_traced", "unit": "ops",
                              "better": "higher", "source": "device_trace",
                              "layer": "replayed tick",
                              "moves": "solves_per_s",
                              "workloads": ["single_short.upright_few"]})
    json.dump(spec, open(tmp_path / "BENCHMARK.json", "w"))

    over = {"config": {"dtype": "float64"}}
    code = (
        "import json, sys, time\n"
        "sys.path[:0] = [%r, %r]\n"
        "from portbench import harness\n"
        "assert harness.__file__.startswith(%r)\n"
        "cell = harness.load_cell('single_short.upright_few')\n"
        "for trace in (False, True):\n"
        "    print(json.dumps(harness.run_cell(cell, 7, 0.01, trace, 'cpu',\n"
        "                                      time.monotonic(), %r)))\n"
        % (str(tmp_path), ROOT, str(tmp_path), over))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = [json.loads(line) for line in out.stdout.splitlines()
                     if line.startswith("{")]
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"solves_per_s", "setup_s"}
    assert traced["metrics"]["replays_traced"]["value"] == 2.0
    for path, body in before.items():
        assert open(path, "rb").read() == body
