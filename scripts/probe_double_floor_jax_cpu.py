"""Probe: the f32 rounding floor of the JAX package's lanes solve on the
double pole's cold problem, on the CPU, as the reference for the floor that
``chip_smoke.py`` measures on the PyTorch port (``[kernel 1 double]``,
``check_compare(..., "floor")``).

The problem is the one the smoke's floor gate solves: bench.py's
double-pole regime (``DOUBLE_SOFT_OPT_KWARGS``: window 60, every terminal
objective a soft cost, no sinusoid kick; 8 GN iterations, spacing 5,
condensed KKT), the perturbed-upright states of ``make_x0s("double", 4096,
seed=0)``, a cold start, f32. The JAX package's solve runs twice on it: as
it is, and with its initial shooting states and controls moved up by one
ulp (the smoke's ``nudge="xs+u"``). The script counts the instances that
take the same path in both (identical termination codes, iteration counts
and accepted step sizes in every iteration, the smoke's ``_agreement``) and
max |du| / mean |u| over them.

Two solve bodies: ``xla`` (``fused=False``, the reference's default
lanes body) and ``fused`` (``fused=True``: the Pallas kernel's tile body,
which the JAX package emulates op by op on the CPU; the body that the
port's kernel 1 and its plain version translate). Nothing of
``cartpole_tpu/`` changes.

Usage: python scripts/probe_double_floor_jax_cpu.py [--batch 4096]
       [--paths xla,fused] [--out double_floor_jax_cpu.json]
(the defaults wrote the committed double_floor_jax_cpu.json).
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
from cartpole_tpu.mpc import lanes  # noqa: E402
from cartpole_tpu.ops.lanes import rollout_rows  # noqa: E402

#: chip_smoke.py's MULTILINK_KWARGS (bench.py's DOUBLE_SOFT_OPT_KWARGS with
#: its 8 iterations and spacing 5).
KWARGS = dict(window_length=60, th_final_cost_weight=150.0,
              th_dot_final_cost_weight=10.0, b_x_dot_final_cost_weight=10.0,
              u_guess_sinusoid_amplitude=0.0, max_iterations=8,
              state_spacing=5, kkt_method="condensed")


def make_x0s(n, seed=0):
    """bench.py's ``make_x0s("double", n)``."""
    rng = np.random.RandomState(seed)
    up = math.pi / 2
    x0s = np.tile(np.array([0.0, up, up, 0.0, 0.0, 0.0]), (n, 1))
    x0s[:, 0] += rng.uniform(-0.3, 0.3, n)
    x0s[:, 1] += rng.uniform(-0.15, 0.15, n)
    x0s[:, 2] += rng.uniform(-0.1, 0.1, n)
    return x0s


def cold_problem(mpc, x0, dp):
    """``step_lanes``'s set-up for a cold start: the zero control guess
    (no sinusoid kick) rolled out to fill the shooting states."""
    spec = mpc.spec
    B, sd = x0.shape
    K, sp = spec.window_length, spec.spacing
    xc = x0.T
    u_guess = jnp.zeros((K, B), x0.dtype)
    core = mpc.model.dynamics_core
    _, steps = rollout_rows(
        lambda xr, u_: core(dp, xr, u_), tuple(xc[i] for i in range(sd)),
        u_guess, mpc.params.control_dt, mpc.model.angle_indices,
        stack_states=True)
    shoot = jnp.stack([jnp.concatenate([xc[i][None], steps[i][sp - 1::sp]])
                       for i in range(sd)])
    problem = lanes._LanesProblem(spec, xc, jnp.zeros((B,), x0.dtype),
                                  jnp.zeros((B,), x0.dtype), dp)
    return problem, lanes._Z(xs=shoot, u=u_guess)


def path_of(Z, out):
    return dict(term=np.asarray(out.termination_state),
                iters=np.asarray(out.n_iterations),
                alpha=np.asarray(out.iter_step_size),  # (B, iters)
                u=np.asarray(Z.u))  # (K, B)


def agreement(a, b):
    """chip_smoke.py's ``_agreement`` in numpy."""
    term_same = a["term"] == b["term"]
    iter_same = a["iters"] == b["iters"]
    alpha_same = np.all(a["alpha"] == b["alpha"], axis=1)
    agree = term_same & iter_same & alpha_same
    du = np.abs(a["u"] - b["u"]).max(0)[agree]
    max_du = float(du.max()) if du.size else math.nan
    scale = float(np.abs(b["u"][:, agree]).mean()) if agree.any() else 0.0
    rel = (max_du / scale if scale > 0
           else (0.0 if max_du == 0 else math.inf))
    return dict(term_differ=int((~term_same).sum()),
                iters_differ=int((~iter_same).sum()),
                alpha_differ=int((~alpha_same).sum()),
                identical_fraction=float(agree.mean()),
                max_abs_du=max_du, rel_du=rel,
                term_histogram=np.bincount(b["term"], minlength=5).tolist())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--paths", default="xla,fused")
    ap.add_argument("--out", default="double_floor_jax_cpu.json")
    args = ap.parse_args()

    model = ct.get_model("double")
    dp = jax.tree.map(lambda v: jnp.asarray(v, jnp.float32),
                      model.default_params())
    mpc = ct.make_mpc(ct.OptimizationParams(**KWARGS), model)
    x0 = jnp.asarray(make_x0s(4096)[:args.batch], jnp.float32)
    problem, Z0 = cold_problem(mpc, x0, dp)
    up = lambda t: jnp.nextafter(t, jnp.full_like(t, jnp.inf))  # noqa: E731
    Z1 = lanes._Z(xs=up(Z0.xs), u=up(Z0.u))

    out = dict(
        what="f32 one-ulp-nudge floor of the JAX package's lanes solve on "
             "the double pole's cold problem, CPU",
        script="scripts/probe_double_floor_jax_cpu.py",
        batch=args.batch, regime=KWARGS, nudge="xs+u (one ulp up)",
        x0=f"first {args.batch} of make_x0s('double', 4096, seed=0)",
        jax=jax.__version__, paths={})
    for name in args.paths.split(","):
        fused = name == "fused"
        opts = {"eager_loop": True} if fused else None
        solve = (
            (lambda Z: lanes._solve_lanes(problem, Z, mpc.nls_config,
                                          fused=True, fused_opts=opts))
            if fused else jax.jit(lambda Z: lanes._solve_lanes(
                problem, Z, mpc.nls_config, fused=False)))
        t0 = time.perf_counter()
        base = path_of(*solve(Z0))
        nudged = path_of(*solve(Z1))
        r = agreement(nudged, base)
        r["wall_s"] = time.perf_counter() - t0
        out["paths"][name] = r
        print(name, json.dumps(r), flush=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
