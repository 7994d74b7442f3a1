"""The port's closed loop against the JAX package's, tick for tick.

A 10-tick ``run_closed_loop_lanes(..., fused=True)`` of the port (fused
solve through the plain version on CPU, lanes plant substeps, auto-reset)
against the jitted reference ``cartpole_tpu.mpc.lanes.run_closed_loop_lanes``
in f64 at a tiny size: states and controls to atol 1e-8, termination codes and iteration
counts equal. The reference program compiles once per module.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

import jax
import jax.numpy as jnp

from cartpole_tpu import OptimizationParams as RefParams
from cartpole_tpu import default_single_params as ref_default_params
from cartpole_tpu import make_mpc as ref_make_mpc
from cartpole_tpu.mpc.lanes import run_closed_loop_lanes as ref_run
from cartpole_tpu.mpc.lanes import simulator_step_lanes as ref_sim
import cartpole_tpu_torch as pt
from cartpole_tpu_torch.convert import params_from_numpy

B, TICKS = 4, 10
KW = dict(window_length=4, state_spacing=2, max_iterations=8,
          kkt_method="condensed")


def _x0():
    rng = np.random.RandomState(3)
    x0 = np.tile([0.0, np.pi / 2, 0.0, 0.0], (B, 1))
    x0[:, 0] += rng.uniform(-0.5, 0.5, B)
    x0[:, 1] += rng.uniform(-0.3, 0.3, B)
    x0[0] = [0.1, -np.pi / 2 + 0.2, 0.0, 0.0]
    return x0


@pytest.fixture(scope="module")
def runs():
    x0 = _x0()
    mpc_r = ref_make_mpc(RefParams(**KW))
    dp = ref_default_params(jnp.float64)
    ref = jax.jit(lambda x: ref_run(mpc_r, x, dp, TICKS))(jnp.asarray(x0))
    mpc = pt.make_mpc(pt.OptimizationParams(**KW))
    out = pt.run_closed_loop_lanes(
        mpc, torch.as_tensor(x0),
        params_from_numpy({k: np.asarray(v) for k, v in dp.as_dict().items()},
                          device="cpu"),
        TICKS, fused=True)
    return ref, out


@pytest.mark.parametrize("name,atol", [
    ("states", 1e-8), ("controls", 1e-8), ("final_state", 1e-8),
    ("terminal_predictions", 1e-7), ("constraint_violations", 1e-9),
])
def test_trajectories_match(runs, name, atol):
    ref, out = runs
    a, b = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=atol)


@pytest.mark.parametrize("name", ["termination_states", "solver_iterations"])
def test_solver_outcomes_match(runs, name):
    ref, out = runs
    np.testing.assert_array_equal(getattr(out, name).numpy(),
                                  np.asarray(getattr(ref, name)))


def test_final_warm_start_matches(runs):
    ref, out = runs
    np.testing.assert_allclose(
        out.final_mpc_state.previous_solution.numpy(),
        np.asarray(ref.final_mpc_state.previous_solution), atol=1e-7)
    np.testing.assert_array_equal(out.final_mpc_state.warm.numpy(),
                                  np.asarray(ref.final_mpc_state.warm))


def test_loop_is_not_degenerate(runs):
    ref, _ = runs
    codes = np.asarray(ref.termination_states)
    assert len(set(codes.ravel().tolist())) >= 2
    assert np.abs(np.asarray(ref.controls)).max() > 1.0


def test_plant_substeps_match_reference():
    rng = np.random.RandomState(5)
    x = rng.uniform(-1.0, 1.0, (4, 6)) * np.array([[0.5], [3.0], [2.0], [5.0]])
    u = rng.uniform(-40.0, 40.0, 6)
    dp = ref_default_params(jnp.float64)
    for dt in (0.01, 0.0125):
        ref = ref_sim(dp, jnp.asarray(x), dt, jnp.asarray(u))
        out = pt.simulator_step_lanes(
            pt.default_single_params(torch.float64, device="cpu"),
            torch.as_tensor(x), dt,
            torch.as_tensor(u))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                                   atol=1e-12)
