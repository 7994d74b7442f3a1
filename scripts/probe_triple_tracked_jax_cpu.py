"""Probe: the triple pole's tracked swing-up through the JAX package on the
CPU, as the witness of the PyTorch port's run of it (``chip_smoke.py``,
``[triple-swingup]``, and ``tests/test_torch_triple_tracked.py``).

The run is ``tests/test_triple.py::TestTrackedSwingUp``: the first
``window - 60`` (240) planned controls of ``triple_swingup_traj.npz``
replayed open loop through the 1 kHz plant from the hanging chain, then
the mid-swing state handed to ``run_closed_loop`` for 150 ticks of the
perturbed-upright MPC (f64, window 60, spacing 5, 8 GN iterations, soft
terminal weights, no sinusoid kick). Records the state after the replay,
the plan's shooting state there, the catch's states at ticks 0-3, 50 and
100 (the state each tick starts from) and after tick 150, its controls at
those ticks, and every tick's termination state.

Usage: python scripts/probe_triple_tracked_jax_cpu.py
       [--out triple_tracked_jax_cpu.json]   (a few minutes on a CPU)
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cartpole_tpu import (TRIPLE_CARTPOLE, OptimizationParams,  # noqa: E402
                          default_triple_params, make_mpc, run_closed_loop)
from cartpole_tpu.mpc.simulator import simulator_step  # noqa: E402

UP = np.pi / 2
#: tests/test_triple.py::TestTrackedSwingUp's catch.
CATCH = dict(window_length=60, state_spacing=5, max_iterations=8,
             th_final_cost_weight=150.0, th_dot_final_cost_weight=10.0,
             b_x_dot_final_cost_weight=10.0, u_guess_sinusoid_amplitude=0.0)
CATCH_TICKS = 150
RECORDED_TICKS = (0, 1, 2, 3, 50, 100)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="triple_tracked_jax_cpu.json")
    args = ap.parse_args()

    traj = np.load(os.path.join(ROOT, "triple_swingup_traj.npz"))
    u_ref = jnp.asarray(np.asarray(traj["u"], np.float64))
    K = int(traj["window"])
    handoff = K - 60
    dp = default_triple_params(jnp.float64)
    hang = jnp.asarray([0.0, -UP, -UP, -UP, 0.0, 0.0, 0.0, 0.0])

    def replay(x0):
        def body(x, u):
            return simulator_step(dp, x, 0.01, u, model=TRIPLE_CARTPOLE), None
        xf, _ = jax.lax.scan(body, x0, u_ref[:handoff])
        return xf

    t0 = time.perf_counter()
    x_mid = jax.jit(replay)(hang)
    x_plan = np.asarray(traj["solution"])[: (K // 20 + 1) * 8].reshape(
        -1, 8)[handoff // 20]
    mpc = make_mpc(OptimizationParams(**CATCH), TRIPLE_CARTPOLE)
    res = jax.jit(lambda x: run_closed_loop(mpc, x, dp, CATCH_TICKS))(x_mid)
    xf = np.asarray(res.final_state)
    wall = time.perf_counter() - t0
    states = np.asarray(res.states)
    controls = np.asarray(res.controls)
    codes = np.asarray(res.termination_states)
    ang_err = float(np.abs(np.mod(xf[1:4] - UP + np.pi, 2 * np.pi)
                           - np.pi).max())
    out = dict(
        what="triple pole tracked swing-up (tests/test_triple.py::"
        "TestTrackedSwingUp): open-loop replay of the plan, then the MPC "
        "catch; JAX package, CPU, f64",
        script="scripts/probe_triple_tracked_jax_cpu.py",
        replay_ticks=handoff,
        catch_params=json.loads(mpc.params.to_json()),
        x_mid=np.asarray(x_mid).tolist(),
        x_plan=x_plan.tolist(),
        catch_ticks=list(RECORDED_TICKS),
        catch_states=[states[t].tolist() for t in RECORDED_TICKS],
        catch_controls=[float(controls[t]) for t in RECORDED_TICKS],
        final_state=xf.tolist(),
        termination_states=codes.tolist(),
        final_angle_error=ang_err,
        final_max_abs_velocity=float(np.abs(xf[4:]).max()),
        wall_s=wall,
    )
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("x_mid", "final_state",
                                          "final_angle_error", "wall_s")}))


if __name__ == "__main__":
    main()
