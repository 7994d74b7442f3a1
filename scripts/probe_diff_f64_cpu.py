"""The JAX package's f64 gradients at ``scripts/probe_diff_tpu.py``'s point.

``probe_diff_tpu.py`` holds the f32 gradient of ``L = sum(u*^2)`` through
one MPC solve (window 40, spacing 5, condensed, 12 GN iterations, from
``x0 = [0.15, pi/2 - 0.15, 0.1, -0.2]``), with respect to ``x0`` and
``m_1``, against central finite differences of the f64 solve
(``diff_tpu_f32.json``'s ``fd_f64_cpu``). This script computes the same
gradients with the JAX package in f64 on the CPU, for both backward
methods, and how far each lies from those finite differences. The solve
stops on its relative tolerance (1e-5) after a few iterations, short of
stationarity, so the ``"ift"`` gradient (exact at a stationary point) sits
~5e-4 from the finite differences while ``"unrolled"`` (the derivative of
the algorithm) sits ~1e-7 from them. ``chip_smoke.py`` holds the port's f64
``"ift"`` gradient on the card to this file's. Writes
``diff_f64_jax_cpu.json``.

Run: python scripts/probe_diff_f64_cpu.py   (CPU, ~30 s)
"""

import json
import math
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

from cartpole_tpu import (  # noqa: E402
    OptimizationParams, default_single_params, make_mpc)
from cartpole_tpu.diff import make_differentiable_solve  # noqa: E402

OUT = os.path.join(ROOT, "diff_f64_jax_cpu.json")


def main():
    with open(os.path.join(ROOT, "diff_tpu_f32.json")) as f:
        fd = json.load(f)["fd_f64_cpu"]
    g_fd, gm_fd = np.asarray(fd["g_x"]), float(fd["g_m1"])
    mpc = make_mpc(OptimizationParams(
        max_iterations=12, state_spacing=5, kkt_method="condensed"))
    dp = default_single_params(jnp.float64)
    x0 = jnp.asarray([0.15, math.pi / 2 - 0.15, 0.1, -0.2], jnp.float64)
    state = mpc.init_state(jnp.float64)
    u_start = mpc.spec.u_start
    _, diag = jax.jit(lambda: make_differentiable_solve(
        mpc, with_diagnostics=True)(x0, dp, 0.0, state))()
    results = {
        "what": "JAX package, f64, CPU: d sum(u*^2) / d (x0, m_1) at the "
                "point of scripts/probe_diff_tpu.py",
        "jax": jax.__version__,
        "date": time.strftime("%Y-%m-%d %H:%M:%S"),
        "diagnostics": {"n_active": int(diag["n_active"]),
                        "termination_state": int(diag["termination_state"])},
    }
    for method in ("ift", "unrolled"):
        solve = make_differentiable_solve(mpc, method=method)

        def loss(x, d, solve=solve):
            return jnp.sum(solve(x, d, 0.0, state)[u_start:] ** 2)

        gx, gd = jax.jit(jax.grad(loss, argnums=(0, 1)))(x0, dp)
        gx, gm = np.asarray(gx), float(gd.m_1)
        results[method] = {
            "g_x": gx.tolist(), "g_m1": gm,
            "max_rel_err_x_vs_fd": float(np.max(np.abs(gx - g_fd)
                                                / np.abs(g_fd))),
            "rel_err_m1_vs_fd": abs(gm - gm_fd) / abs(gm_fd),
        }
        print(method, json.dumps(results[method]), flush=True)
    with open(OUT, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
