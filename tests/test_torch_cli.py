"""The port's CLI (``python -m cartpole_tpu_torch``), in-process on the CPU.

Each subcommand prints the JSON keys of the JAX package's CLI
(``cartpole_tpu/cli.py``); ``closed-loop``'s final state equals the port's
``run_closed_loop`` at 1e-12 in f64; ``replay`` of the written log gives
its states back; without ``--cpu`` on a machine with no CUDA device the CLI
exits non-zero with a message; ``sweep --layout auto`` picks ``vmap`` where
the fused kernel does not cover the problem (re-based terminal
equalities) instead of failing; typos in ``--params`` and ``--dynamics``
get the designed errors. One subprocess runs ``--help``. Small config:
window 10, spacing 2, 3 GN iterations.
"""

import contextlib
import io
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

import cartpole_tpu_torch as pt  # noqa: E402
from cartpole_tpu_torch import cli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"window_length": 10, "state_spacing": 2, "max_iterations": 3}
P = ["--cpu", "--params", json.dumps(SMALL)]
STEPS = 6
SWEEP_KEYS = {"batch", "steps", "layout", "devices", "wall_s",
              "solves_per_s", "n_failed_solves", "mean_iterations",
              "max_violation", "fraction_upright"}
LOOP_KEYS = {"steps", "wall_s", "final_state", "termination_histogram",
             "n_failed", "max_constraint_violation_after_warmup"}


def _run(capsys, *argv):
    """``cli.main(argv)``: its exit code and the JSON it printed before
    any "wrote ..." line."""
    rc = cli.main(list(argv))
    out = capsys.readouterr().out
    return rc, out


def _json(out):
    return json.loads(out.split("\nwrote ")[0])


@pytest.fixture(scope="module")
def loop_log(tmp_path_factory):
    """One closed-loop run through the CLI, its printed summary and log."""
    log = str(tmp_path_factory.mktemp("cli") / "log.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["closed-loop", *P, "--steps", str(STEPS),
                       "--log-json", log])
    return rc, _json(buf.getvalue()), log


def test_solve_prints_summary_and_log(capsys, tmp_path):
    path = tmp_path / "solve.json"
    rc, out = _run(capsys, "solve", *P, "--json", str(path))
    assert rc == 0
    assert out.startswith("termination = ") and "iter  0" in out
    assert "device: cpu, dtype: torch.float64" in out
    entry = json.loads(path.read_text())
    assert set(entry) == {"initial_state", "previous_solution",
                          "solver_outputs", "u", "predicted_states"}
    assert len(entry["u"]) == SMALL["window_length"]


def test_closed_loop_matches_run_closed_loop(loop_log):
    rc, summary, _ = loop_log
    assert rc == 0 and set(summary) == LOOP_KEYS
    assert summary["steps"] == STEPS and summary["n_failed"] == 0
    mpc = pt.make_mpc(pt.OptimizationParams(**SMALL))
    dp = pt.default_single_params(torch.float64, device="cpu")
    x0 = torch.tensor([0.0, -math.pi / 2, 0.0, 0.0], dtype=torch.float64)
    res = pt.run_closed_loop(mpc, x0, dp, STEPS)
    np.testing.assert_allclose(summary["final_state"],
                               res.final_state.numpy(), rtol=0, atol=1e-12)


def test_replay_reproduces_the_log(loop_log, capsys):
    _, _, log = loop_log
    entries = json.loads(open(log).read())
    assert len(entries) == STEPS
    assert set(entries[0]) == {"state", "u", "termination_state"}
    rc, out = _run(capsys, "replay", log)
    rep = _json(out)
    assert rc == 0 and set(rep) == {
        "ticks", "state_dim", "final_state", "has_predictions",
        "termination_histogram", "n_failed", "max_abs_u"}
    assert rep["ticks"] == STEPS and rep["state_dim"] == 4
    assert rep["final_state"] == entries[-1]["state"]
    assert rep["max_abs_u"] == max(abs(e["u"]) for e in entries)
    assert not rep["has_predictions"]


def test_closed_loop_schedule(capsys):
    rc, out = _run(capsys, "closed-loop", *P, "--schedule",
                   '[[2, {"u_derivative_cost_weight": 0.8}], [2, null]]')
    summary = _json(out)
    assert rc == 0 and set(summary) == LOOP_KEYS and summary["steps"] == 4
    with pytest.raises(ValueError, match="decision-vector layout"):
        cli.main(["closed-loop", *P, "--schedule",
                  '[[3, {"window_length": 20}]]'])


@pytest.mark.parametrize("layout", ["vmap", "lanes", "lanes-fused"])
def test_sweep_layouts(capsys, layout):
    rc, out = _run(capsys, "sweep", *P, "--batch", "4", "--steps", "2",
                   "--layout", layout)
    summary = _json(out)
    assert rc == 0 and set(summary) == SWEEP_KEYS
    assert summary["layout"] == layout and summary["batch"] == 4
    assert summary["devices"] == 1 and summary["n_failed_solves"] == 0


def test_sweep_results_file(capsys, tmp_path):
    path = str(tmp_path / "sweep.npz")
    rc, out = _run(capsys, "sweep", *P, "--batch", "4", "--steps", "2",
                   "--layout", "lanes-fused", "--f32", "--results", path)
    summary = _json(out)
    with np.load(path) as data:
        assert data["controls"].shape == (4, 2)
        assert data["controls"].dtype == np.float32
        assert data["final_state"].shape == (4, 4)
        assert int(data["diagnostics/n_instances"]) == 4
        assert float(data["summary/max_violation"]) == summary[
            "max_violation"]


def test_sweep_auto_layout(capsys):
    """auto takes the fused kernel where it covers the problem, and vmap
    where re-basing meets terminal equalities (which the fused kernel
    refuses) instead of failing."""
    rc, out = _run(capsys, "sweep", *P, "--batch", "2", "--steps", "1")
    assert rc == 0 and _json(out)["layout"] == "lanes-fused"
    rebased = json.dumps({**SMALL, "rebase_equalities": True})
    rc, out = _run(capsys, "sweep", "--cpu", "--params", rebased,
                   "--batch", "2", "--steps", "1")
    assert rc == 0 and _json(out)["layout"] == "vmap"
    schur = json.dumps({**SMALL, "kkt_method": "schur"})
    rc, out = _run(capsys, "sweep", "--cpu", "--params", schur,
                   "--batch", "2", "--steps", "1")
    assert rc == 0 and _json(out)["layout"] == "vmap"


def test_no_cuda_without_cpu_flag_exits(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["solve"], ["closed-loop", "--steps", "1"],
                 ["sweep", "--batch", "2", "--steps", "1"], ["interactive"],
                 ["web", "--port", "0"]):
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code not in (0, None)
        assert "no CUDA device" in str(exc.value.code)
        assert "--cpu" in str(exc.value.code)


def test_interactive_scripted_run(capsys, tmp_path, monkeypatch):
    """Without a tty: 200 ticks, the pole poked before tick 101, the final
    state printed and (``--log-json``) the solve log written."""
    monkeypatch.setattr(sys, "stdin", io.StringIO())
    log = tmp_path / "log.json"
    fast = json.dumps({"window_length": 10, "state_spacing": 5,
                       "max_iterations": 1})
    rc, out = _run(capsys, "interactive", "--cpu", "--params", fast,
                   "--log-json", str(log))
    assert rc == 0
    final = json.loads(out.split("final state: ")[1].split("\n")[0])
    entries = json.loads(log.read_text())
    assert len(entries) == 200 and len(final) == 4
    assert set(entries[0]) == {"initial_state", "previous_solution",
                               "solver_outputs", "u", "predicted_states"}
    assert entries[0]["initial_state"]["th_1"] == -math.pi / 2
    assert all(round(v, 4) == v for v in final)


def test_web_serves_the_flags_loop(monkeypatch):
    """``web`` hands ``serve`` a loop built from the common flags."""
    got = {}
    monkeypatch.setattr("cartpole_tpu_torch.web.serve",
                        lambda host, port, loop: got.update(
                            host=host, port=port, loop=loop))
    assert cli.main(["web", "--cpu", "--model", "double", "--set-point",
                     "0.2", "--port", "0", "--host", "0.0.0.0"]) == 0
    loop = got["loop"]
    assert (got["host"], got["port"]) == ("0.0.0.0", 0)
    assert loop.device.type == "cpu" and loop.dtype == torch.float64
    assert loop.model is pt.DOUBLE_CARTPOLE and loop.set_point == 0.2
    assert loop.params.window_length == 60 and not loop.render
    assert loop.x.tolist() == [0.0, -math.pi / 2, -math.pi / 2, 0, 0, 0]


def test_typos_get_the_designed_errors():
    with pytest.raises(ValueError, match="unknown SingleCartPoleParams"):
        cli.main(["solve", "--cpu", "--dynamics", '{"m1": 0.2}'])
    with pytest.raises(ValueError, match="unknown OptimizationParams field"):
        cli.main(["solve", "--cpu", "--params", '{"windowlength": 60}'])


def test_help_as_a_module():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-m", "cartpole_tpu_torch", "--help"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    # The JAX package's six subcommands.
    assert "{solve,closed-loop,sweep,interactive,web,replay}" in res.stdout
