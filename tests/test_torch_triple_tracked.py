"""The triple pole's tracked swing-up (``tests/test_triple.py::
TestTrackedSwingUp``) through the port, in f64 on the CPU, against the JAX
package's run of it (``triple_tracked_jax_cpu.json``, written by
``scripts/probe_triple_tracked_jax_cpu.py``).

The first 240 planned controls of ``triple_swingup_traj.npz`` replayed open
loop through the port's ``simulator_step`` from the hanging chain give the
JAX package's mid-swing state within 1e-8 (9.4e-13 measured), and it lies
on the plan (within 0.5, the reference test's gate). The catch's first
three ticks of ``run_closed_loop`` at the full width (window 60, spacing 5,
8 iterations, soft terminal weights) give its states and controls within
1e-8 (1.0e-12 measured on the states) and the same termination codes. The
whole 150-tick catch runs on the card (``chip_smoke.py``,
``[triple-swingup]``).
"""

import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

import cartpole_tpu_torch as pt  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATCH_TICKS = 3
TOL = 1e-8


@pytest.fixture(scope="module")
def witness():
    with open(os.path.join(ROOT, "triple_tracked_jax_cpu.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def replay():
    """The port's open-loop replay: the mid-swing state, and the plan's
    shooting state there."""
    traj = np.load(os.path.join(ROOT, "triple_swingup_traj.npz"))
    K = int(traj["window"])
    handoff = K - 60
    dp = pt.default_triple_params(torch.float64, device="cpu")
    up = math.pi / 2
    x = torch.tensor([0.0, -up, -up, -up, 0.0, 0.0, 0.0, 0.0],
                     dtype=torch.float64)
    for u in torch.as_tensor(np.asarray(traj["u"], np.float64)[:handoff]):
        x = pt.simulator_step(dp, x, 0.01, u, model=pt.TRIPLE_CARTPOLE)
    x_plan = np.asarray(traj["solution"])[: (K // 20 + 1) * 8].reshape(
        -1, 8)[handoff // 20]
    return handoff, x, x_plan


def test_replay_matches_the_jax_package(witness, replay):
    handoff, x_mid, x_plan = replay
    assert handoff == witness["replay_ticks"] == 240
    np.testing.assert_allclose(x_mid.numpy(), witness["x_mid"], rtol=0,
                               atol=TOL)
    assert np.abs(x_mid.numpy() - x_plan).max() < 0.5


def test_catch_ticks_match_the_jax_package(witness, replay):
    _, x_mid, _ = replay
    mpc = pt.make_mpc(pt.OptimizationParams(**witness["catch_params"]),
                      pt.TRIPLE_CARTPOLE)
    dp = pt.default_triple_params(torch.float64, device="cpu")
    res = pt.run_closed_loop(mpc, x_mid, dp, CATCH_TICKS)
    ticks = witness["catch_ticks"]
    states = np.concatenate([res.states.numpy(),
                             res.final_state.numpy()[None]])
    for t in range(CATCH_TICKS + 1):
        np.testing.assert_allclose(
            states[t], witness["catch_states"][ticks.index(t)], rtol=0,
            atol=TOL, err_msg=f"tick {t}")
    np.testing.assert_allclose(
        res.controls.numpy(),
        [witness["catch_controls"][ticks.index(t)]
         for t in range(CATCH_TICKS)], rtol=TOL, atol=TOL)
    assert res.termination_states.tolist() == \
        witness["termination_states"][:CATCH_TICKS]
