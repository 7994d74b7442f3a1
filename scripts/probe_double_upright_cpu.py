"""Probe: the double pole's upright share, tick by tick, through the JAX
package's lanes closed loop on the CPU, as a reference for the PyTorch
port's run of the same regime on a GPU (``chip_smoke.py``, ``[double]``).

The regime is bench.py's double-pole outcome run (``_double_health``):
``DOUBLE_SOFT_OPT_KWARGS`` with 8 GN iterations and spacing 5, the
perturbed-upright states of ``make_x0s("double", 4096, seed=0)`` (the
first ``--batch`` of them), f32, and the schedule
``[(transient, {"u_derivative_cost_weight": 0.8}), (ticks - transient,
None)]`` (bench.py's transient is 50 ticks) through
``run_scheduled_closed_loop(layout="lanes", fused=False)`` (the XLA body;
the Pallas kernel would run in interpret mode here). Records, for every
tick, the share of instances with every link within 0.1 rad of upright
(bench.py's ``_upright_fraction``) over the plant states the loop starts
each tick from, and after the last tick; and the count of failed solves.

Usage: python scripts/probe_double_upright_cpu.py [--batch 512]
       [--ticks 250] [--transient 50] [--out double_upright_jax_cpu.json]
(the defaults wrote the committed double_upright_jax_cpu.json, in about an
hour on an 8-core CPU; ``--ticks 15 --transient 10 --out
double_upright_switch_jax_cpu.json`` wrote the witness of the smoke's
shortened schedule, which switches to the base weights at tick 10).
"""

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import cartpole_tpu as ct  # noqa: E402
from cartpole_tpu import run_scheduled_closed_loop  # noqa: E402

#: bench.py: DOUBLE_SOFT_OPT_KWARGS, DOUBLE_TRANSIENT_OPT_KWARGS and
#: DOUBLE_TRANSIENT_TICKS (copied: bench.py sets a compile cache beside
#: itself when imported).
SOFT = dict(window_length=60, th_final_cost_weight=150.0,
            th_dot_final_cost_weight=10.0, b_x_dot_final_cost_weight=10.0,
            u_guess_sinusoid_amplitude=0.0)
TRANSIENT, TRANSIENT_TICKS = dict(u_derivative_cost_weight=0.8), 50


def make_x0s(n, seed=0):
    """bench.py's ``make_x0s("double", n)``."""
    rng = np.random.RandomState(seed)
    up = math.pi / 2
    x0s = np.tile(np.array([0.0, up, up, 0.0, 0.0, 0.0]), (n, 1))
    x0s[:, 0] += rng.uniform(-0.3, 0.3, n)
    x0s[:, 1] += rng.uniform(-0.15, 0.15, n)
    x0s[:, 2] += rng.uniform(-0.1, 0.1, n)
    return x0s


def upright(x, angle_indices=(1, 2)):
    th = np.asarray(x)[..., list(angle_indices)]
    err = np.abs(np.mod(th - math.pi / 2 + math.pi, 2 * math.pi) - math.pi)
    return np.all(err < 0.1, axis=-1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--ticks", type=int, default=250)
    ap.add_argument("--transient", type=int, default=TRANSIENT_TICKS)
    ap.add_argument("--chunk", type=int, default=25)
    ap.add_argument("--out", default="double_upright_jax_cpu.json")
    args = ap.parse_args()

    model = ct.get_model("double")
    dp = jax.tree.map(lambda v: jnp.asarray(v, jnp.float32),
                      model.default_params())
    mpc = ct.make_mpc(ct.OptimizationParams(
        **SOFT, max_iterations=8, state_spacing=5, kkt_method="condensed"),
        model)
    x0 = jnp.asarray(make_x0s(4096)[:args.batch], jnp.float32)
    schedule = [(args.transient, TRANSIENT),
                (args.ticks - args.transient, None)]
    t0 = time.perf_counter()
    res = run_scheduled_closed_loop(
        mpc, x0, dp, schedule, layout="lanes", fused=False,
        max_ticks_per_program=args.chunk)
    xf = np.asarray(res.final_state)
    wall = time.perf_counter() - t0
    states = np.asarray(res.states)  # (B, T, sd): the state each tick
    per_tick = upright(states).mean(0).tolist() + [float(upright(xf).mean())]
    term = np.asarray(res.termination_states)
    out = dict(
        what="double-pole upright share per tick, JAX package, CPU, f32",
        script="scripts/probe_double_upright_cpu.py",
        batch=args.batch, ticks=args.ticks, schedule=schedule,
        x0="first {} of make_x0s('double', 4096, seed=0)".format(
            args.batch),
        upright_by_tick=per_tick,
        n_failed=int(np.sum((term == 3) | (term == 4))),
        finite=bool(np.isfinite(states).all() and np.isfinite(xf).all()),
        wall_s=wall,
    )
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(json.dumps({k: v for k, v in out.items()
                      if k != "upright_by_tick"}))
    print("upright at ticks 0,25,50,75,...:",
          [round(per_tick[t], 4) for t in range(0, len(per_tick), 25)],
          "end", round(per_tick[-1], 4))


if __name__ == "__main__":
    main()
