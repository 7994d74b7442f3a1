#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

Drives the port's main path — the batched closed-loop MPC of
``cartpole_tpu_torch.run_closed_loop_lanes`` with the fused Gauss-Newton
kernel — at the bench point of the JAX package (single cart-pole, condensed
KKT, f32, batch 4096, window 40, spacing 5, 8 GN iterations, 5 line-search
trials, 300 ticks from bench.py's swing-up initial states, seed 0), after
building the kernel from ``cartpole_tpu_torch/csrc`` and holding it against
its plain PyTorch version on the card.

Phases, each fatal on failure: device, build, kernel against plain version
(cold-start problem), main path, kernel against plain version (the
warm-start problems after tick 1 and after the last tick of the main path),
timings. The gates of each comparison are in ``check_compare``. Prints the card's name and
power limit, one JSON line describing the kernel, and as its last line
``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py
Needs one CUDA device, nvcc (CUDA toolkit) and the repository beside it.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

import cartpole_tpu_torch as pt
from cartpole_tpu_torch.mpc import lanes
from cartpole_tpu_torch.ops import _build, fused


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def bench_x0s(n: int, seed: int = 0) -> np.ndarray:
    """bench.py's single-model initial states: swing-up from hang with the
    cart and angle perturbed by U(-0.5, 0.5)."""
    rng = np.random.RandomState(seed)
    x0s = np.tile(np.array([0.0, -math.pi / 2, 0.0, 0.0]), (n, 1))
    x0s[:, 0] += rng.uniform(-0.5, 0.5, n)
    x0s[:, 1] += rng.uniform(-0.5, 0.5, n)
    return x0s


def upright_fraction(xf: np.ndarray) -> float:
    """bench.py's definition: pole within 0.1 rad of upright."""
    th = xf[:, 1]
    return float(np.mean(
        np.abs(np.mod(th - math.pi / 2 + math.pi, 2 * math.pi) - math.pi)
        < 0.1))


def _plain_solve(args, carry, n_iter):
    rows = []
    for _ in range(n_iter):
        outs = fused.fused_iteration_reference(*args, *carry)
        carry, tr = outs[:8], outs[8:]
        rows.append(tr)
    return carry, rows


def _agreement(ca, ta, cb, tb):
    """Instances that took the same path — identical termination codes,
    iteration counts and accepted step sizes in every iteration — and max
    |du| over them (relative to mean |u| there). An instance whose Armijo
    test sits on its bound can accept a step one iteration earlier or later
    under either rounding; it then ends elsewhere and is counted as
    differing, not folded into the error of the instances that agree."""
    term_same = ca[6] == cb[6]
    iter_same = ta[5].sum(0) == tb[5].sum(0)
    alpha_same = (ta[3] == tb[3]).all(0)
    agree = term_same & iter_same & alpha_same
    du = (ca[1] - cb[1]).abs().amax(0)[agree]
    max_abs_du = float(du.max()) if du.numel() else float("nan")
    return dict(
        term_differ=int((~term_same).sum()),
        iters_differ=int((~iter_same).sum()),
        alpha_differ=int((~alpha_same).sum()),
        identical_fraction=float(agree.float().mean()),
        max_abs_du=max_abs_du,
        rel_du=max_abs_du / float(cb[1][:, agree].abs().mean()),
    )


def compare(mpc, state, x, nudge=False):
    """Kernel (one launch, n_iter iterations) against the plain version
    (n_iter calls of fused_iteration_reference) on the problem of one tick,
    both on the card in f32; n_iter launches of one iteration against the
    one launch; and both f32 results against the plain version in f64 (the
    accuracy f32 allows). With ``nudge``, also the plain version against
    itself with the initial controls moved by one ulp: the rounding-noise
    floor of the termination decisions."""
    config = mpc.nls_config
    n_iter = config.max_iterations

    def setup(dtype):
        dp = pt.default_single_params(dtype, x.device)
        st = pt.MPCState(state.previous_solution.to(dtype), state.warm)
        problem, Z0 = lanes._prepare(mpc, st, x.to(dtype), dp)
        args = (problem.statics.fused, dp, problem.x_current,
                problem.set_point, problem.u_prev)
        return args, lanes._init_carry(Z0, config)

    def plain(args, carry):
        c, rows = _plain_solve(args, carry, n_iter)
        return c, tuple(torch.stack([r[k] for r in rows]) for k in range(6))

    args, carry0 = setup(torch.float32)
    ck, tk = fused.fused_solve(*args, carry0, n_iter)
    cp, tp = plain(args, carry0)
    out = dict(batch=int(ck[6].numel()), **_agreement(ck, tk, cp, tp))

    # n_iter x one-iteration launches must equal the single launch.
    c1, rows1 = carry0, []
    for _ in range(n_iter):
        c1, t1 = fused.fused_solve(*args, c1, 1)
        rows1.append(t1)

    def same(a, b):
        return bool(torch.all((a == b) | (torch.isnan(a) & torch.isnan(b))))

    out["split_launch_identical"] = all(
        same(a, b) for a, b in zip(c1, ck)) and all(
        same(torch.cat([r[k] for r in rows1]), tk[k]) for k in range(6))
    out["term_histogram"] = np.bincount(
        ck[6].cpu().numpy(), minlength=5).tolist()

    # Accuracy against f64, over the instances all three agree on.
    c64, t64 = plain(*setup(torch.float64))
    both = ((ck[6] == c64[6]) & (tk[5].sum(0) == t64[5].sum(0))
            & (cp[6] == c64[6]) & (tp[5].sum(0) == t64[5].sum(0)))
    def quantiles(c):
        e = (c[1].double() - c64[1]).abs().amax(0)[both]
        if not e.numel():
            return {"p999": math.nan, "max": math.nan}
        return {"p50": float(torch.quantile(e, 0.5)),
                "p99": float(torch.quantile(e, 0.99)),
                "p999": float(torch.quantile(e, 0.999)),
                "max": float(e.max())}

    out["vs_f64"] = dict(
        agree_fraction=float(both.float().mean()),
        mean_abs_u=float(c64[1][:, both].abs().mean()),
        kernel_err=quantiles(ck), plain_err=quantiles(cp),
    )
    if nudge:
        u1 = torch.nextafter(carry0[1], torch.full_like(carry0[1], math.inf))
        cn, tn = plain(args, (carry0[0], u1) + carry0[2:])
        out["plain_vs_nudged_plain"] = _agreement(cn, tn, cp, tp)
    return out


def check_compare(tag, r, gate):
    """The agreement gates; every problem also needs the split launches
    identical to the single launch.

    * ``"strict"`` (cold start, warm start after tick 1): >= 99.9 % of
      instances on the same path (``_agreement``), max |du| / mean |u|
      <= 1e-3 over them, and the kernel's error against the f64 plain
      version at most twice the f32 plain version's (99.9th percentile over
      the batch).
    * ``"noise"`` (warm start after the last tick): identical fraction
      within 2 points of the plain version's agreement with itself after a
      one-ulp nudge of its initial controls. The termination decisions of
      converged warm starts sit at f32 rounding noise: even the plain
      version disagrees with itself there.
    """
    print(f"[{tag}] kernel vs plain: {json.dumps(r)}", flush=True)
    ident = r["identical_fraction"]
    if gate == "noise":
        ok = ident >= r["plain_vs_nudged_plain"]["identical_fraction"] - 0.02
    else:
        v = r["vs_f64"]
        ok = (ident >= 0.999 and r["rel_du"] <= 1e-3
              and v["kernel_err"]["p999"] <= 2 * v["plain_err"]["p999"])
    if not (ok and r["split_launch_identical"]):
        raise SystemExit(f"[{tag}] kernel disagrees with its plain version")


def time_cuda(fn, reps):
    """Mean ms per call of ``fn`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


BATCH, TICKS = 4096, 300


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    # ---------------------------------------------------------------- device
    card = _card()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ----------------------------------------------------------------- build
    t0 = time.perf_counter()
    path, log = _build.build_library()
    _build.load_library()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s -> {os.path.relpath(path)}", flush=True)
    for line in log.splitlines():
        if "registers" in line or "stack frame" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    # ------------------------------------------- kernel vs plain, cold start
    B = BATCH
    mpc = pt.make_mpc(pt.OptimizationParams(
        max_iterations=8, state_spacing=5, kkt_method="condensed"))
    cfg = mpc.nls_config
    dp = pt.default_single_params(torch.float32, dev)
    x0 = torch.as_tensor(bench_x0s(B), dtype=torch.float32, device=dev)
    cold = pt.MPCState(
        previous_solution=torch.zeros((B, mpc.spec.dim), device=dev),
        warm=torch.zeros((B,), dtype=torch.bool, device=dev),
    )
    r_cold = compare(mpc, cold, x0)
    check_compare("cold, tick 0", r_cold, "strict")

    # ------------------------------------------------------------- main path
    # Two calls carrying (plant state, MPCState), as bench.py chains its
    # chunks: the state after tick 1 gives the first warm-start problem.
    torch.cuda.synchronize()
    fused.fused_solve.launches = 0
    t0 = time.perf_counter()
    res1 = pt.run_closed_loop_lanes(mpc, x0, dp, 1)
    res = pt.run_closed_loop_lanes(mpc, res1.final_state, dp, TICKS - 1,
                                   mpc_state=res1.final_mpc_state)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = fused.fused_solve.launches
    term = torch.cat([res1.termination_states, res.termination_states], 1)
    failed = (term == 3) | (term == 4)  # MPC.failure_mask's solver codes
    failed |= ~torch.isfinite(torch.cat(
        [res1.states, res.states], 1)).all(-1)  # ... and non-finite runs
    n_failed = int(failed.sum())
    upright = upright_fraction(res.final_state.cpu().numpy())
    print(f"[main] {TICKS} ticks x batch {B}: {loop_s:.2f} s, "
          f"{launches} kernel launches, n_failed {n_failed}, "
          f"fraction_upright {upright:.4f}  ({card})", flush=True)
    if launches < TICKS:
        raise SystemExit("main path launched the kernel fewer times than "
                         "it ran ticks")
    if n_failed != 0 or upright < 0.99:
        raise SystemExit("main path failed: n_failed or fraction_upright")
    if not torch.isfinite(res.controls).all():
        raise SystemExit("main path produced non-finite controls")

    # ------------------------------------------ kernel vs plain, warm starts
    r_warm = compare(mpc, res1.final_mpc_state,
                     res1.final_state)
    check_compare("warm, tick 1", r_warm, "strict")
    r_end = compare(mpc, res.final_mpc_state,
                    res.final_state, nudge=True)
    check_compare(f"warm, tick {TICKS}", r_end, "noise")

    # --------------------------------------------------------------- timings
    tick_ms = []
    x, mst = res.final_state, res.final_mpc_state
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r1 = pt.run_closed_loop_lanes(mpc, x, dp, 1, mpc_state=mst)
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        x, mst = r1.final_state, r1.final_mpc_state
    med_tick = float(np.median(tick_ms))
    problem_w, Z0_w = lanes._prepare(mpc, res.final_mpc_state,
                                     res.final_state, dp)
    wargs = (problem_w.statics.fused, dp, problem_w.x_current,
             problem_w.set_point, problem_w.u_prev)
    carry_w = lanes._init_carry(Z0_w, cfg)
    kern_ms = time_cuda(
        lambda: fused.fused_solve(*wargs, carry_w, cfg.max_iterations),
        20)

    def plain_solve():
        c = carry_w
        for _ in range(cfg.max_iterations):
            c = fused.fused_iteration_reference(*wargs, *c)[:8]

    plain_ms = time_cuda(plain_solve, 1)
    print(f"[timing] solves/s {B * TICKS / loop_s:.1f} "
          f"(main path, {TICKS} ticks); ms/tick mean "
          f"{loop_s / TICKS * 1e3:.2f}, median {med_tick:.2f} "
          f"(20 single ticks); kernel {kern_ms:.3f} ms/solve "
          f"(8 iterations, 1 launch), plain version {plain_ms:.3f} "
          f"ms/solve; kernel share of the median tick "
          f"{kern_ms / med_tick:.4f}, glue {1 - kern_ms / med_tick:.4f}  "
          f"({card})", flush=True)

    print(json.dumps({"kernels": [{
        "name": "fused_iteration",
        "route": "cuda",
        "source": "cartpole_tpu_torch/csrc/fused_iteration.cu",
        "replaces": "cartpole_tpu/ops/fused.py:938",
        "launches": launches,
        "max_abs_err": max(r_cold["max_abs_du"], r_warm["max_abs_du"]),
        "ms": kern_ms,
        "plain_ms": plain_ms,
    }]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
