"""The port's counterparts of ``examples/swingup.py`` and
``examples/batch_sweep.py`` (``cartpole_tpu_torch/tools/``), in-process on
the CPU at a tiny size.

``tools/swingup.py`` writes its solve log (which loads) and its plots;
``tools/batch_sweep.py`` prints the JAX example's keys on both of the
example's layouts (``vmap`` by default, ``lanes-fused`` with ``--fused``),
which agree, and its checkpoint restores the final warm starts.
Without ``--device cpu`` on a machine with no card both exit with a
message.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

from cartpole_tpu_torch.tools import batch_sweep, swingup  # noqa: E402
from cartpole_tpu_torch.utils import load_log, load_state  # noqa: E402

#: The keys examples/batch_sweep.py prints.
SWEEP_KEYS = {"wall_s", "solves_per_s", "fraction_upright",
              "n_failed_solves", "mean_solver_iterations"}
#: Each tool's controller, shrunk: a shorter window, the example's
#: iterations.
SMALL = {"window_length": 10, "state_spacing": 2}


def test_swingup_writes_its_files(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(swingup, "BASE_PARAMS", dict(
        swingup.BASE_PARAMS, window_length=4, state_spacing=2))
    res, outputs = swingup.main([
        "--device", "cpu", "--steps", "5", "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "final state:" in out and "termination" in out
    assert tuple(res.states.shape) == (5, 4)
    assert torch.isfinite(res.states).all()
    for name in ("log.json", "trajectory.png", "strips.png"):
        assert os.path.getsize(tmp_path / name) > 0, name
    entries = load_log(str(tmp_path / "log.json"))
    assert len(entries) == 1
    x = res.final_state.numpy()
    assert entries[0]["initial_state"] == {
        "b_x": x[0], "th_1": x[1], "th_1_dot": x[3], "b_x_dot": x[2]}
    np.testing.assert_array_equal(entries[0]["u"], outputs.u.numpy())


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """batch_sweep at batch 8, 3 ticks, on each layout (``fused`` False:
    the default, ``vmap``), with a checkpoint."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(batch_sweep, "BASE_PARAMS",
                   dict(batch_sweep.BASE_PARAMS, **SMALL))
        for fused in (False, True):
            path = str(tmp_path_factory.mktemp("sweep") / "ck.npz")
            argv = ["--device", "cpu", "--batch", "8", "--steps", "3",
                    "--checkpoint", path]
            out[fused] = batch_sweep.main(
                argv + (["--fused"] if fused else [])) + (path,)
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_batch_sweep_prints_the_example_keys(sweeps, fused, capsys):
    summary, result, _ = sweeps[fused]
    assert set(summary) == SWEEP_KEYS
    assert summary["n_failed_solves"] == 0
    assert tuple(result.states.shape) == (8, 3, 4)


@pytest.mark.parametrize("fused", [False, True])
def test_batch_sweep_checkpoint_round_trips(sweeps, fused):
    _, result, path = sweeps[fused]
    st = result.final_mpc_state
    like = type(st)(torch.zeros_like(st.previous_solution),
                    torch.zeros_like(st.warm))
    back = load_state(path, like)
    assert torch.equal(back.previous_solution, st.previous_solution)
    assert torch.equal(back.warm, st.warm)


def test_batch_sweep_layouts_agree(sweeps):
    """The per-instance solve under ``vmap`` and kernel 1's plain version
    on the same per-scenario problems, f32: the same codes and iterations,
    states within 1e-4."""
    a, b = sweeps[False][1], sweeps[True][1]
    assert torch.equal(a.termination_states, b.termination_states)
    assert torch.equal(a.solver_iterations, b.solver_iterations)
    np.testing.assert_allclose(a.states.numpy(), b.states.numpy(),
                               atol=1e-4)


def test_batch_sweep_draws_a_grid_per_scenario():
    grid, x0s = batch_sweep.scenario_grid(8, torch.float64)
    assert len(set(grid.m_1.tolist())) == 8
    assert len(set(grid.l_1.tolist())) == 8
    assert float(grid.m_1.min()) >= 0.05 and float(grid.l_1.max()) <= 0.4
    assert tuple(x0s.shape) == (8, 4)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("tool", [swingup, batch_sweep])
def test_tools_need_the_card_or_device_cpu(tool):
    with pytest.raises(SystemExit, match="device cpu"):
        tool.main(["--steps", "1"])
