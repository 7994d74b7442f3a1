"""Probe: the JAX package's ``python -m cartpole_tpu interactive`` run
without a tty, on the CPU, as the witness of the PyTorch port's run of the
same script on a GPU (``chip_smoke.py``, ``[interactive]``).

Without a tty the subcommand runs 200 ticks of ``InteractiveLoop`` from the
hanging pole with the CLI's defaults (single cart-pole, f64, window 40,
spacing 10, 8 GN iterations, set point 0) and pokes the pole mass before
tick 101 (the command list ``[None] * 100 + ["p"] + [None] * 99``). This
script builds the loop as ``cartpole_tpu/cli.py::_cmd_interactive`` does
(its ``_setup`` on the default flags with ``--cpu``), runs the same
commands, and records, for every 10th tick n (1-based), the n-th entry of
the solve log: the state the tick solved from, its ``u[0]`` and its
termination state; and the state after the last tick, as printed by the
subcommand (4 decimals) and in full.

Usage: python scripts/probe_interactive_jax_cpu.py
       [--out interactive_jax_cpu.json]   (about a minute on a CPU)
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from cartpole_tpu import cli  # noqa: E402
from cartpole_tpu.interactive import InteractiveLoop  # noqa: E402

TICKS, POKE_BEFORE = 200, 100
COMMANDS = [None] * POKE_BEFORE + ["p"] + [None] * (TICKS - POKE_BEFORE - 1)


def entry_state(entry):
    """The single pole's packed state ``[b_x, th_1, b_x_dot, th_1_dot]``
    from a log entry's ``initial_state`` (the log orders its fields
    ``b_x, th_1, th_1_dot, b_x_dot``)."""
    s = entry["initial_state"]
    return [s["b_x"], s["th_1"], s["b_x_dot"], s["th_1_dot"]]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="interactive_jax_cpu.json")
    args = ap.parse_args()

    flags = argparse.Namespace(model="single", params="{}", dynamics="{}",
                               x0=None, set_point=0.0, f32=False, cpu=True)
    mpc, dynamics_params, x0, dtype = cli._setup(flags)
    loop = InteractiveLoop(params=mpc.params, dynamics_params=dynamics_params,
                           dtype=dtype, model=mpc.model, render=False)
    loop.x = x0
    loop.set_point = flags.set_point
    t0 = time.perf_counter()
    loop.run(max_ticks=TICKS, realtime=False, commands=COMMANDS)
    wall = time.perf_counter() - t0
    entries = loop.log.entries()
    assert len(entries) == TICKS
    ticks = list(range(10, TICKS + 1, 10))
    xf = np.asarray(loop.x, dtype=float)
    out = dict(
        what="python -m cartpole_tpu interactive without a tty: the n-th "
        "solve-log entry's state, u[0] and termination state every 10 "
        "ticks, and the state after the last tick; JAX package, CPU, f64",
        script="scripts/probe_interactive_jax_cpu.py",
        params=json.loads(mpc.params.to_json()),
        commands=f"[None] * {POKE_BEFORE} + ['p'] + [None] * "
        f"{TICKS - POKE_BEFORE - 1}",
        ticks=ticks,
        states=[entry_state(entries[n - 1]) for n in ticks],
        u0=[entries[n - 1]["u"][0] for n in ticks],
        termination_states=[
            entries[n - 1]["solver_outputs"]["termination_state"]
            for n in ticks],
        final_state=xf.tolist(),
        final_state_printed=[round(float(v), 4) for v in xf],
        wall_s=wall,
    )
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("final_state", "wall_s")}))


if __name__ == "__main__":
    main()
