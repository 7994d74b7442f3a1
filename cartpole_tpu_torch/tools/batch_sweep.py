"""Scenario sweep over a (pole mass, pole length) grid (the port of
``examples/batch_sweep.py``).

Thousands of independent MPC instances, each with its own plant physics
(``m_1`` drawn from [0.05, 0.2], ``l_1`` from [0.15, 0.4], the rest
nominal) and a hanging pole moved by up to 0.3 rad (numpy, seed 0), run
through ``parallel.make_sharded_closed_loop(..., batched_params=True)``
over the scenario mesh (one rank, or every rank under ``torchrun``), with
all-reduced health diagnostics and an optional checkpoint of the final
warm starts (``utils.save_state``). The controller is the example's:
condensed KKT, spacing 5, 10 GN iterations.

The batch runs in the example's layouts: ``vmap`` by default
(``torch.func.vmap`` of the per-instance closed loop, as the example's
``jax.vmap``; no kernel of the repo), or ``lanes-fused`` with ``--fused``
(kernel 1 once a tick; f32 only). On the card each closed loop replays a
CUDA-graph capture of its tick. The example's per-shard ``batch_tile``
constraint has no counterpart: it sized the TPU kernel's tiles. The
lanes layout with kernel 2 is the CLI's: ``python -m cartpole_tpu_torch
sweep --layout lanes``.

Usage, from the repository root:
    python3 -m cartpole_tpu_torch.tools.batch_sweep [--batch 512]
        [--steps 150] [--fused] [--f64] [--checkpoint F.npz]
        [--device cpu]
Runs on the card unless ``--device cpu`` is given. Prints the example's
JSON keys.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import OptimizationParams, default_single_params, make_mpc
from ..parallel import (gather_scenarios, initialize_distributed,
                        make_scenario_mesh, make_sharded_closed_loop,
                        shard_scenarios)

#: The example's controller.
BASE_PARAMS = dict(state_spacing=5, max_iterations=10,
                   kkt_method="condensed")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--checkpoint", default=None,
                    help="save final warm-start states to this .npz")
    ap.add_argument("--fused", action="store_true",
                    help="solve each tick with one launch of the fused "
                    "GN-iteration kernel (layout lanes-fused, f32)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def scenario_grid(n: int, dtype, device="cpu"):
    """``(dynamics params with (n,) fields, x0s (n, 4))``: the example's
    grid and initial states, from ``numpy.random.RandomState(0)``."""
    rng = np.random.RandomState(0)
    base = default_single_params(dtype, device=device)
    grid = dataclasses.replace(
        type(base)(**{k: torch.broadcast_to(v, (n,))
                      for k, v in base.as_dict().items()}),
        m_1=torch.as_tensor(rng.uniform(0.05, 0.2, n), dtype=dtype),
        l_1=torch.as_tensor(rng.uniform(0.15, 0.4, n), dtype=dtype),
    )
    x0s = np.tile(np.array([0.0, -math.pi / 2, 0.0, 0.0]), (n, 1))
    x0s[:, 1] += rng.uniform(-0.3, 0.3, n)
    return grid, torch.as_tensor(x0s, dtype=dtype)


def main(argv=None):
    """Run the sweep; returns ``(summary, result)``: the printed summary
    and the rank's ``ClosedLoopResult``."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    if args.fused and args.f64:
        raise SystemExit("--fused runs in f32 only")
    dtype = torch.float64 if args.f64 else torch.float32

    initialize_distributed()
    mesh = make_scenario_mesh(device="cpu" if device.type == "cpu" else None)
    n = args.batch
    if mesh.rank == 0:
        print(f"{mesh.world_size} rank(s) on {mesh.device}; {n} scenarios",
              flush=True)
    grid, x0s = scenario_grid(n, dtype)
    mpc = make_mpc(OptimizationParams(
        **BASE_PARAMS))
    run = make_sharded_closed_loop(
        mpc, mesh, num_steps=args.steps, batched_params=True,
        layout="lanes-fused" if args.fused else "vmap")

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        if mesh.group is not None:
            dist.barrier(mesh.group)

    x0s, grid, set_points = shard_scenarios(
        (x0s, grid, torch.zeros((n,), dtype=dtype)), mesh)
    sync()
    t0 = time.perf_counter()
    result, diag = run(x0s, grid, set_points)
    sync()
    wall = time.perf_counter() - t0

    final = gather_scenarios({"x": result.final_state,
                              "mpc_state": result.final_mpc_state}, mesh)
    # The example's upright test: theta within 1e-2 of pi/2.
    upright = torch.abs(final["x"][:, 1] - math.pi / 2) < 1e-2
    summary = {
        "wall_s": round(wall, 2),
        "solves_per_s": round(n * args.steps / wall, 1),
        "fraction_upright": float(upright.double().mean()),
        "n_failed_solves": int(diag.n_failed),
        "mean_solver_iterations": round(float(diag.mean_iterations), 2),
    }
    if mesh.rank == 0:
        print(json.dumps(summary, indent=2))
        if args.checkpoint:
            from ..utils import save_state

            save_state(args.checkpoint, final["mpc_state"])
            print(f"warm-start states saved to {args.checkpoint}")
    return summary, result


if __name__ == "__main__":
    main()
