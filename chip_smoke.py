#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

Drives both solve paths of ``cartpole_tpu_torch.run_closed_loop_lanes`` at
the bench point of the JAX package (single cart-pole, condensed KKT, f32,
batch 4096, window 40, spacing 5, 8 GN iterations, 5 line-search trials,
bench.py's swing-up initial states, seed 0):

* path 1, ``fused=True``: the whole solve as one launch of kernel 1
  (``csrc/fused_iteration.cu``), 300 ticks;
* path 2, ``fused=False``: the reference's XLA-lanes body, whose
  linearization is one launch of kernel 2 (``csrc/segment_jac.cu``) per GN
  iteration, the rest eager torch (``TICKS_PATH2`` ticks).

Phases, each fatal on failure: device; build (both kernels in one library,
one nvcc per source in parallel; both kernels' registers, stack frames and
spills, kernel 2 for each of its step-count instantiations, none of which
may spill in f32); segment_jac (kernel 2 against its plain version, f64 and f32, on
random columns, a ragged R that leaves the last block part full, one and
SPMAX steps per segment, and the cold-start shooting problem); kernel 1
against its plain version (cold start, and a ragged batch of RAGGED
instances that leaves the last block part full); path 1; kernel 1 against
its plain version (warm starts after tick 1 and the last tick); disturbed
(100 ticks of path 1 with a shove at the pole mass); path 2; kernel 2
against its plain version on the warm linearization after path 2's last
tick; cross (path 2 against path 1 on the cold-start problem, and path 2
under ``torch.set_float32_matmul_precision("high")``); timing (both
kernels by device time, ``device_ms``: kernel 1 on the warm problem after
path 1's last tick, kernel 2 on the cold and the warm problem) and a
profile of one tick of each path (device-busy share, kernel launches), with
both kernels' launch layouts (registers, shared bytes per block, resident
blocks and warps per SM).
Every kernel launch counter is set to 0 just before a path is driven and
read just after. Prints the card's name and power limit beside every number, one JSON
line describing the kernels, and as its last line ``{"ok": true, "device":
{...}}``.

Usage: python3 chip_smoke.py
Needs one CUDA device, nvcc (CUDA toolkit) and the repository beside it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import cartpole_tpu_torch as pt
from cartpole_tpu_torch.mpc import lanes
from cartpole_tpu_torch.ops import _build, fused
from cartpole_tpu_torch.ops import pallas_kernels as pk

BATCH, TICKS, TICKS_PATH2, TICKS_DISTURBED = 4096, 300, 300, 100
#: A batch that is not a multiple of kernel 1's instances per block, and a
#: column count that is not one of kernel 2's columns per block.
RAGGED, RAGGED_COLUMNS = 4093, 32765
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s off the
#: tensor cores.
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12


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


def _upright_error(th):
    """|th - pi/2| wrapped to [0, pi]."""
    return np.abs(np.mod(th - math.pi / 2 + math.pi, 2 * math.pi) - math.pi)


def upright_fraction(xf: np.ndarray) -> float:
    """bench.py's definition: pole within 0.1 rad of upright."""
    return float(np.mean(_upright_error(xf[:, 1]) < 0.1))


def reset_counts():
    fused.fused_solve.launches = 0
    pk.segment_jac_batch_last.launches = 0


def counts():
    return dict(fused_iteration=fused.fused_solve.launches,
                segment_jac=pk.segment_jac_batch_last.launches)


# ------------------------------------------------------------- op counting
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "sin", "cos", "tanh",
    "sqrt", "rsqrt", "reciprocal", "pow", "maximum", "minimum", "clamp",
    "clamp_min", "clamp_max", "where", "remainder", "fmod", "gt", "lt", "ge",
    "le", "eq", "ne", "logical_and", "logical_or", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_not", "isfinite", "isnan", "exp",
    "log", "sign", "floor",
}
_REDUCTIONS = {"sum", "amax", "amin", "max", "min", "any", "all", "argmax",
               "mean"}


class OpCounter(TorchDispatchMode):
    """Arithmetic operations of a plain-version call, as torch dispatches
    them: one per output element of an elementwise op, one per input
    element of a reduction, 2mnk per matrix product. Copies, views and
    allocations count nothing."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name in ("mm", "addmm", "bmm"):
            a, b = (args[1], args[2]) if name == "addmm" else args[:2]
            self.ops += 2 * a.numel() * b.shape[-1]
        elif name in _REDUCTIONS:
            self.ops += args[0].numel()
        elif name in _ELEMENTWISE and isinstance(out, torch.Tensor):
            self.ops += out.numel()
        return out


def count_ops(fn) -> int:
    with OpCounter() as c:
        fn()
    return c.ops


def bound(n_bytes: float, n_ops: float):
    """Least time on the card (ms) for the work, and what bounds it."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


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


def device_ms(fns, reps=20, rounds=7, hold_cycles=20_000_000):
    """Median and least device ms per call of each of ``fns`` (a dict),
    over ``rounds`` rounds in which the functions take turns, each round
    ``reps`` calls between two CUDA events. A kernel shorter than the
    host's enqueue of a call would leave the card idle between launches,
    and the events would time the host: so the card is first held busy
    (``torch.cuda._sleep``, ~10 ms) while the host enqueues the calls, and
    a round whose first event had already passed when the last call was
    enqueued fails."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            torch.cuda._sleep(hold_cycles)
            t0.record()
            for _ in range(reps):
                fn()
            t1.record()
            if t0.query():
                raise SystemExit(f"device_ms: the card idled while {k} "
                                 f"was enqueued")
            t1.synchronize()
            times[k].append(t0.elapsed_time(t1) / reps)
    return {k: (float(np.median(v)), min(v)) for k, v in times.items()}


def clocks() -> str:
    """The card's SM clock, its maximum, power draw and temperature now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def ptxas_entries(log: str):
    """Each kernel entry of a ``ptxas -v`` log: the kernel's name, for
    kernel 2 its steps per segment and real type, registers, stack frame
    bytes and spill-store bytes."""
    out, lines = [], log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" not in line:
            continue
        props = next(x for x in lines[i + 1:] if "stack frame" in x)
        regs = next(x for x in lines[i + 1:] if "registers" in x)
        e = dict(kernel=None, registers=int(
            re.search(r"Used (\d+) registers", regs).group(1)),
                 stack=int(re.search(r"(\d+) bytes stack frame",
                                     props).group(1)),
                 spill=int(re.search(r"(\d+) bytes spill stores",
                                     props).group(1)))
        if "fused_iteration_kernel" in line:
            e["kernel"] = "fused_iteration"
        m = re.search(r"segment_jac_kernelILi(\d+)E([fd])E", line)
        if m:
            e.update(kernel="segment_jac", sp=int(m.group(1)),
                     dtype="f32" if m.group(2) == "f" else "f64")
        out.append(e)
    return out


def time_host(fn, reps):
    """Mean ms per synchronised call of ``fn`` by the host clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def profile_ticks(mpc, dp, x, mst, fused_flag, n=1):
    """``n`` warm ticks under ``torch.profiler``: wall ms, device-busy ms
    (sum of the CUDA kernels' self time), and kernel launches, per tick."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            r = pt.run_closed_loop_lanes(mpc, x, dp, 1, mpc_state=mst,
                                         fused=fused_flag)
            x, mst = r.final_state, r.final_mpc_state
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy_us, launches = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += e.self_device_time_total
        elif e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                       "cuLaunchKernel"):
            launches += e.count
    return dict(wall_ms=wall / n, device_busy_ms=busy_us / 1e3 / n,
                device_idle_share=1 - busy_us / 1e3 / wall,
                launches=launches / n)


# ------------------------------------------------------------- kernel 2
def segment_inputs_random(R, sp, dev, seed=0):
    rng = np.random.RandomState(seed)
    xs = rng.uniform(-1, 1, (4, R)) * np.array([[1.0], [4.0], [3.0], [8.0]])
    us = rng.uniform(-10, 10, (sp, R))
    dp = pt.default_single_params(torch.float64, dev)
    p = fused.params_block(dp, R, torch.float64, dev)
    return p, torch.as_tensor(xs, device=dev), torch.as_tensor(us, device=dev)


def segment_inputs_problem(problem, Z):
    """The linearization inputs of ``condensed_step``, in f64."""
    x_start, useg = problem._fold_segments(Z)
    p = lanes._fold_lanes(fused.params_block(
        problem.dynamics_params, problem.B, Z.u.dtype, Z.u.device),
        problem.S, problem.B)
    return tuple(t.double().contiguous() for t in (p, x_start, useg))


def check_segment_jac(tag, inputs, h, angle, card):
    """Kernel 2 against its plain version on the same inputs: f64 kernel
    vs f64 plain within 1e-12 x max(1, |value|) on every output; f32
    kernel vs f64 plain at most twice the f32 plain version's error (99.9th
    percentile over columns of each output's worst element)."""
    p64, x64, u64 = inputs
    k64 = pk.segment_jac_batch_last(p64, x64, u64, h, angle)
    ref = pk.segment_jac_batch_last_reference(p64, x64, u64, h, angle)
    f32 = tuple(t.float() for t in inputs)
    k32 = pk.segment_jac_batch_last(*f32, h, angle)
    p32 = pk.segment_jac_batch_last_reference(*f32, h, angle)
    torch.cuda.synchronize()
    out, ok = {}, True
    for name, a64, a32, b32, r in zip(("x_end", "Jx", "Ju"), k64, k32, p32,
                                      ref):
        scale = torch.clamp_min(r.abs(), 1.0)
        e64 = float(((a64 - r).abs() / scale).max())

        def p999(a):
            e = ((a.double() - r).abs() / scale).reshape(-1, r.shape[-1])
            return float(torch.quantile(e.amax(0), 0.999))

        ek, ep = p999(a32), p999(b32)
        finite = bool(torch.isfinite(a64).all() and torch.isfinite(a32).all())
        ok &= finite and e64 <= 1e-12 and ek <= 2 * ep
        out[name] = dict(f64_max_rel=e64, f32_kernel_p999=ek,
                         f32_plain_p999=ep, finite=finite)
    max_abs = max(float((a - b).abs().max()) for a, b in zip(k32, p32))
    print(f"[segment_jac] {tag}, R={x64.shape[1]}: {json.dumps(out)}; "
          f"f32 kernel vs f32 plain max abs {max_abs:.3e}  ({card})",
          flush=True)
    if not ok:
        raise SystemExit(f"[segment_jac] {tag}: kernel disagrees with its "
                         f"plain version")
    return max_abs


# ------------------------------------------------------------- kernel 1
def _plain_solve(args, carry, n_iter):
    rows = []
    for _ in range(n_iter):
        outs = fused.fused_iteration_reference(*args, *carry)
        carry, tr = outs[:8], outs[8:]
        rows.append(tr)
    return carry, tuple(torch.stack([r[k] for r in rows]) for k in range(6))


def path_of(carry, traces):
    """The path of a kernel-1 style solve: termination codes, iteration
    counts, accepted step sizes (iters, B), controls (K, B)."""
    return dict(term=carry[6], iters=traces[5].sum(0), alpha=traces[3],
                u=carry[1])


def path_of_outputs(Z, out):
    """The same for a ``_solve_lanes`` result."""
    return dict(term=out.termination_state, iters=out.n_iterations,
                alpha=out.iter_step_size.T, u=Z.u)


def _agreement(a, b):
    """Instances that took the same path — identical termination codes,
    iteration counts and accepted step sizes in every iteration — and max
    |du| over them (relative to mean |u| there). An instance whose Armijo
    test sits on its bound can accept a step one iteration earlier or later
    under either rounding; it then ends elsewhere and is counted as
    differing, not folded into the error of the instances that agree."""
    term_same = a["term"] == b["term"]
    iter_same = a["iters"] == b["iters"]
    alpha_same = (a["alpha"] == b["alpha"]).all(0)
    agree = term_same & iter_same & alpha_same
    du = (a["u"] - b["u"]).abs().amax(0)[agree]
    max_abs_du = float(du.max()) if du.numel() else float("nan")
    return dict(
        term_differ=int((~term_same).sum()),
        iters_differ=int((~iter_same).sum()),
        alpha_differ=int((~alpha_same).sum()),
        identical_fraction=float(agree.float().mean()),
        max_abs_du=max_abs_du,
        rel_du=max_abs_du / float(b["u"][:, agree].abs().mean()),
    )


def setup_problem(mpc, state, x, dtype):
    dp = pt.default_single_params(dtype, x.device)
    st = pt.MPCState(state.previous_solution.to(dtype), state.warm)
    problem, Z0 = lanes._prepare(mpc, st, x.to(dtype), dp)
    return problem, Z0


def compare(mpc, state, x, nudge=False):
    """Kernel 1 (one launch, n_iter iterations) against the plain version
    (n_iter calls of fused_iteration_reference) on the problem of one tick,
    both on the card in f32; n_iter launches of one iteration against the
    one launch; and both f32 results against the plain version in f64 (the
    accuracy f32 allows). With ``nudge``, also the plain version against
    itself with the initial controls moved by one ulp: the rounding-noise
    floor of the termination decisions."""
    config = mpc.nls_config
    n_iter = config.max_iterations

    def setup(dtype):
        problem, Z0 = setup_problem(mpc, state, x, dtype)
        args = (problem.statics.fused, problem.dynamics_params,
                problem.x_current, problem.set_point, problem.u_prev)
        return args, lanes._init_carry(Z0, config)

    args, carry0 = setup(torch.float32)
    ck, tk = fused.fused_solve(*args, carry0, n_iter)
    cp, tp = _plain_solve(args, carry0, n_iter)
    out = dict(batch=int(ck[6].numel()),
               **_agreement(path_of(ck, tk), path_of(cp, tp)))

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
    c64, t64 = _plain_solve(*setup(torch.float64), n_iter)
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
        cn, tn = _plain_solve(args, (carry0[0], u1) + carry0[2:], n_iter)
        out["plain_vs_nudged_plain"] = _agreement(path_of(cn, tn),
                                                  path_of(cp, tp))
    return out


def check_compare(tag, r, gate, card):
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
    print(f"[{tag}] kernel vs plain: {json.dumps(r)}  ({card})", flush=True)
    ident = r["identical_fraction"]
    if gate == "noise":
        ok = ident >= r["plain_vs_nudged_plain"]["identical_fraction"] - 0.02
    else:
        v = r["vs_f64"]
        ok = (ident >= 0.999 and r["rel_du"] <= 1e-3
              and v["kernel_err"]["p999"] <= 2 * v["plain_err"]["p999"])
    if not (ok and r["split_launch_identical"]):
        raise SystemExit(f"[{tag}] kernel disagrees with its plain version")


def kernel1_ops(st, args, carry, traces):
    """Operations this solve's data needs (the kernel skips frozen
    instances and stops its line search at the first accepted trial):
    per active instance-iteration the plain iteration's base count, plus
    per trial evaluated the count of one trial, both from the plain version
    on this batch."""
    B = carry[1].shape[-1]
    n_ls = st.n_ls
    one = dataclasses.replace(st, config=dataclasses.replace(
        st.config, max_line_search_iterations=1))
    t_all = count_ops(lambda: fused.fused_iteration_reference(*args, *carry))
    t_one = count_ops(lambda: fused.fused_iteration_reference(
        one, *args[1:], *carry))
    per_trial = (t_all - t_one) / ((n_ls - 1) * B)
    base = t_one / B - per_trial
    applied = traces[5] != 0
    alpha = traces[3]
    k = torch.where(alpha > 0, 1.0 - torch.log2(alpha.double().clamp_min(
        1e-30)), float(n_ls))
    trials = float(k[applied].sum())
    return base * float(applied.sum()) + per_trial * trials


# ------------------------------------------------------------- closed loops
def n_failed(res_list):
    term = torch.cat([r.termination_states for r in res_list], 1)
    failed = (term == 3) | (term == 4)  # MPC.failure_mask's solver codes
    failed |= ~torch.isfinite(torch.cat(
        [r.states for r in res_list], 1)).all(-1)  # ... and non-finite runs
    return int(failed.sum())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    return run(torch.device("cuda", 0))


def run(dev) -> int:
    """Every phase on ``dev``; raises ``SystemExit`` on the first failed
    gate."""
    # ---------------------------------------------------------------- device
    card = _card()
    print(f"card: {card}", flush=True)

    # ----------------------------------------------------------------- build
    t0 = time.perf_counter()
    path, log = _build.build_library()
    _build.load_library()
    build_s = time.perf_counter() - t0
    print(f"[build] {build_s:.1f} s -> {os.path.relpath(path)}", flush=True)
    if not log:
        print("[build] the library was built before: no ptxas report",
              flush=True)
    entries = ptxas_entries(log)
    for e in entries:
        if e["kernel"] == "fused_iteration":
            print(f"[build] kernel 1 (fused_iteration, "
                  f"{fused.LANES_PER_INSTANCE} lanes per instance): "
                  f"{e['registers']} registers; {e['stack']} B stack frame, "
                  f"{e['spill']} B spill stores", flush=True)
    for dtype in ("f32", "f64") if log else ():
        k2 = [e for e in entries
              if e["kernel"] == "segment_jac" and e["dtype"] == dtype]
        if len(k2) != pk.SPMAX:
            raise SystemExit(f"[build] {len(k2)} {dtype} kernel-2 entries "
                             f"in the ptxas log, not {pk.SPMAX}")
        main_sp = next(e for e in k2 if e["sp"] == 5)
        print(f"[build] kernel 2 (segment_jac, {dtype}, one thread per "
              f"column, sp=5): {main_sp['registers']} registers; "
              f"{main_sp['stack']} B stack frame, {main_sp['spill']} B "
              f"spill stores; over sp=1..{pk.SPMAX}: "
              f"{min(e['registers'] for e in k2)}-"
              f"{max(e['registers'] for e in k2)} registers, stack frames "
              f"up to {max(e['stack'] for e in k2)} B, spill stores up to "
              f"{max(e['spill'] for e in k2)} B", flush=True)
        if dtype == "f32" and any(e["spill"] for e in k2):
            raise SystemExit("[build] kernel 2 spills in f32")

    B = BATCH
    mpc = pt.make_mpc(pt.OptimizationParams(
        max_iterations=8, state_spacing=5, kkt_method="condensed"))
    cfg = mpc.nls_config
    h, angle = mpc.params.control_dt, mpc.model.angle_indices
    dp = pt.default_single_params(torch.float32, dev)
    x0 = torch.as_tensor(bench_x0s(B), dtype=torch.float32, device=dev)
    cold = pt.MPCState(
        previous_solution=torch.zeros((B, mpc.spec.dim), device=dev),
        warm=torch.zeros((B,), dtype=torch.bool, device=dev),
    )

    # ---------------------------------------- kernel 2 vs its plain version
    S, sp = mpc.spec.num_states - 1, mpc.spec.spacing
    R = S * B
    check_segment_jac("random columns, seed 0",
                      segment_inputs_random(R, sp, dev), h, angle, card)
    check_segment_jac("random columns, ragged", segment_inputs_random(
        RAGGED_COLUMNS, sp, dev, seed=1), h, angle, card)
    for n_steps in (1, pk.SPMAX):
        check_segment_jac(f"random columns, sp={n_steps}",
                          segment_inputs_random(R, n_steps, dev, seed=2), h,
                          angle, card)
    problem_c, Z0_c = setup_problem(mpc, cold, x0, torch.float64)
    seg_cold = segment_inputs_problem(problem_c, Z0_c)
    seg_err = check_segment_jac("cold-start shooting problem", seg_cold, h,
                                angle, card)
    rest = segment_inputs_random(R, sp, dev)
    rest_x = torch.zeros_like(rest[1])
    rest_x[1] = -math.pi / 2
    for dtype in (torch.float64, torch.float32):
        outs = pk.segment_jac_batch_last(
            rest[0].to(dtype), rest_x.to(dtype),
            torch.zeros_like(rest[2], dtype=dtype), h, angle)
        if not all(bool(torch.isfinite(o).all()) for o in outs):
            raise SystemExit(f"[segment_jac] non-finite at rest ({dtype})")
    print("[segment_jac] rest state: finite in f64 and f32", flush=True)

    # ---------------------------------------- kernel 1 vs its plain version
    r_cold = compare(mpc, cold, x0)
    check_compare("cold, tick 0", r_cold, "strict", card)
    r_ragged = compare(mpc, pt.MPCState(cold.previous_solution[:RAGGED],
                                        cold.warm[:RAGGED]), x0[:RAGGED])
    check_compare(f"cold, tick 0, ragged batch {RAGGED}", r_ragged, "strict",
                  card)

    # ------------------------------------------------------ path 1 (fused)
    # Two calls carrying (plant state, MPCState), as bench.py chains its
    # chunks: the state after tick 1 gives the first warm-start problem.
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res1 = pt.run_closed_loop_lanes(mpc, x0, dp, 1, fused=True)
    res = pt.run_closed_loop_lanes(mpc, res1.final_state, dp, TICKS - 1,
                                   mpc_state=res1.final_mpc_state, fused=True)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    n1 = counts()
    failed1 = n_failed([res1, res])
    upright = upright_fraction(res.final_state.cpu().numpy())
    print(f"[path 1] fused=True, {TICKS} ticks x batch {B}: {loop_s:.2f} s, "
          f"launches {n1}, n_failed {failed1}, fraction_upright "
          f"{upright:.4f}  ({card})", flush=True)
    if n1["fused_iteration"] != TICKS or n1["segment_jac"] != 0:
        raise SystemExit("path 1 did not launch kernel 1 once per tick")
    if failed1 != 0 or upright < 0.99:
        raise SystemExit("path 1 failed: n_failed or fraction_upright")
    if not torch.isfinite(res.controls).all():
        raise SystemExit("path 1 produced non-finite controls")

    # ---------------------------------------- kernel 1, warm-start problems
    r_warm = compare(mpc, res1.final_mpc_state, res1.final_state)
    check_compare("warm, tick 1", r_warm, "strict", card)
    r_end = compare(mpc, res.final_mpc_state, res.final_state, nudge=True)
    check_compare(f"warm, tick {TICKS}", r_end, "noise", card)

    # ------------------------------------------- disturbed run on path 1
    if upright_fraction(res.final_state.cpu().numpy()) != 1.0:
        raise SystemExit("[disturbed] path 1 did not end with every pole "
                         "upright")
    dist = torch.zeros((B, TICKS_DISTURBED, 2, 2), device=dev)
    dist[:, 10:20, 1, 0] = 4.0  # horizontal force at the pole mass (N)
    t0 = time.perf_counter()
    res_d = pt.run_closed_loop_lanes(
        mpc, res.final_state, dp, TICKS_DISTURBED,
        mpc_state=res.final_mpc_state, disturbances=dist, fused=True)
    torch.cuda.synchronize()
    dist_s = time.perf_counter() - t0
    states = res_d.states.cpu().numpy()
    shove = _upright_error(states[:, 10:36, 1]).max(1)
    shown = float(np.mean(shove > 5e-3))
    failed_d = n_failed([res_d])
    up_d = upright_fraction(res_d.final_state.cpu().numpy())
    finite_d = bool(np.isfinite(states).all())
    print(f"[disturbed] {TICKS_DISTURBED} ticks x batch {B}, 4 N at the pole "
          f"mass over ticks 10-19: {dist_s:.2f} s, n_failed {failed_d}, "
          f"finite {finite_d}, shove visible (max |th - pi/2| over ticks "
          f"10-35 > 5e-3) for {shown:.4f} (median peak "
          f"{float(np.median(shove)):.4e} rad), fraction_upright at the end "
          f"{up_d:.4f}  ({card})", flush=True)
    if failed_d or not finite_d or shown < 0.99 or up_d < 0.99:
        raise SystemExit("[disturbed] failed")

    # ---------------------------------------------------- path 2 (XLA body)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res2 = pt.run_closed_loop_lanes(mpc, x0, dp, TICKS_PATH2, fused=False)
    torch.cuda.synchronize()
    loop2_s = time.perf_counter() - t0
    n2 = counts()
    failed2 = n_failed([res2])
    upright2 = upright_fraction(res2.final_state.cpu().numpy())
    print(f"[path 2] fused=False, {TICKS_PATH2} ticks x batch {B}: "
          f"{loop2_s:.2f} s, launches {n2}, n_failed {failed2}, "
          f"fraction_upright {upright2:.4f}  ({card})", flush=True)
    if (n2["segment_jac"] != TICKS_PATH2 * cfg.max_iterations
            or n2["fused_iteration"] != 0):
        raise SystemExit("path 2 did not launch kernel 2 once per GN "
                         "iteration")
    if failed2 != 0 or upright2 < 0.99:
        raise SystemExit("path 2 failed: n_failed or fraction_upright")
    if not torch.isfinite(res2.controls).all():
        raise SystemExit("path 2 produced non-finite controls")

    # ------------------------------- kernel 2, the warm linearization
    problem2, Z02 = lanes._prepare(mpc, res2.final_mpc_state,
                                   res2.final_state, dp)
    seg_warm = segment_inputs_problem(problem2, Z02)
    seg_err = max(seg_err, check_segment_jac(
        f"warm linearization after tick {TICKS_PATH2} of path 2", seg_warm,
        h, angle, card))

    # ------------------------------------------- path 2 against path 1
    problem32, Z0_32 = setup_problem(mpc, cold, x0, torch.float32)
    Za, oa = lanes._solve_lanes(problem32, Z0_32, cfg, fused=False)
    Zb, ob = lanes._solve_lanes(problem32, Z0_32, cfg, fused=True)
    cross = _agreement(path_of_outputs(Za, oa), path_of_outputs(Zb, ob))
    Za2, _ = lanes._solve_lanes(problem32, Z0_32, cfg, fused=False)
    torch.set_float32_matmul_precision("high")
    try:
        Zh, _ = lanes._solve_lanes(problem32, Z0_32, cfg, fused=False)
    finally:
        torch.set_float32_matmul_precision("highest")
    cross["deterministic"] = bool(torch.equal(Za2.u, Za.u))
    cross["u_identical_under_high_precision_setting"] = bool(
        torch.equal(Zh.u, Za.u))
    print(f"[cross] path 2 vs path 1, cold start, batch {B}, f32: "
          f"{json.dumps(cross)}  ({card})", flush=True)
    if not (cross["identical_fraction"] >= 0.999 and cross["rel_du"] <= 1e-3
            and cross["u_identical_under_high_precision_setting"]):
        raise SystemExit("[cross] path 2 disagrees with path 1")

    # --------------------------------------------------------------- timings
    def median_tick(fused_flag, x, mst, n=20):
        ms = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r1 = pt.run_closed_loop_lanes(mpc, x, dp, 1, mpc_state=mst,
                                          fused=fused_flag)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            x, mst = r1.final_state, r1.final_mpc_state
        return float(np.median(ms))

    med_tick = median_tick(True, res.final_state, res.final_mpc_state)
    med_tick2 = median_tick(False, res2.final_state, res2.final_mpc_state)
    for name, flag, r in (("path 1", True, res), ("path 2", False, res2)):
        prof = profile_ticks(mpc, dp, r.final_state, r.final_mpc_state, flag)
        print(f"[profile] {name}, one warm tick under torch.profiler: "
              f"{json.dumps(prof)}  ({card})", flush=True)

    # Kernel 1 on the warm problem after the last tick of path 1.
    problem_w, Z0_w = lanes._prepare(mpc, res.final_mpc_state,
                                     res.final_state, dp)
    wargs = (problem_w.statics.fused, dp, problem_w.x_current,
             problem_w.set_point, problem_w.u_prev)
    carry_w = lanes._init_carry(Z0_w, cfg)
    k1_t = device_ms({"warm": lambda: fused.fused_solve(
        *wargs, carry_w, cfg.max_iterations)}, reps=5)
    kern_ms = k1_t["warm"][0]
    plain_ms = time_cuda(
        lambda: _plain_solve(wargs, carry_w, cfg.max_iterations), 1)
    _, io_c, io_t, io = fused.kernel_io(*wargs, *carry_w, cfg.max_iterations)
    k1_bytes = sum(t.numel() * t.element_size() for t in io.values())
    del io_c, io
    c_w, t_w = fused.fused_solve(*wargs, carry_w, cfg.max_iterations)
    k1_ops = kernel1_ops(problem_w.statics.fused, wargs, carry_w, t_w)
    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    occ = fused.kernel_occupancy(problem_w.statics.fused, B)

    # Kernel 2 on the cold-start shooting problem and on path 2's warm
    # linearization, f32.
    seg32 = tuple(t.float() for t in seg_cold)
    warm32 = tuple(t.float() for t in seg_warm)
    clocks_before = clocks()
    k2_t = device_ms({
        "cold": lambda: pk.segment_jac_batch_last(*seg32, h, angle),
        "warm": lambda: pk.segment_jac_batch_last(*warm32, h, angle)})
    k2_ms, k2_warm_ms = k2_t["cold"][0], k2_t["warm"][0]
    k2_host_ms = time_cuda(
        lambda: pk.segment_jac_batch_last(*seg32, h, angle), 50)
    occ2 = pk.kernel_occupancy(R, sp)
    k2_plain_ms = time_cuda(
        lambda: pk.segment_jac_batch_last_reference(*seg32, h, angle), 3)
    outs = pk.segment_jac_batch_last(*seg32, h, angle)
    k2_bytes = sum(t.numel() * t.element_size() for t in seg32 + outs)
    k2_ops = count_ops(
        lambda: pk.segment_jac_batch_last_reference(*seg32, h, angle))
    k2_bound, k2_by = bound(k2_bytes, k2_ops)

    # Path 2's split, on the warm problem after its last tick.
    lam = torch.full((B,), cfg.lambda_initial, device=dev)
    n_ls = cfg.max_line_search_iterations
    with fused.full_f32_matmul():
        step_ms = time_host(lambda: problem2.condensed_step(Z02, lam), 5)
        dZ = problem2.condensed_step(Z02, lam)[0]
        trials = problem2.tiled(n_ls)
        alphas = torch.tensor([0.5 ** i for i in range(n_ls)], device=dev)
        rep = lambda a: lanes._fold_lanes(a, n_ls, B)  # noqa: E731
        Za_t = trials.retract(
            lanes._Z(rep(Z02.xs), rep(Z02.u)), lanes._Z(rep(dZ.xs),
                                                       rep(dZ.u)),
            alphas[:, None].expand(n_ls, B).reshape(-1))
        trial_ms = time_host(lambda: trials.evaluate(Za_t), 5)
    n_it = cfg.max_iterations
    print(f"[timing] path 1: solves/s {B * TICKS / loop_s:.1f} ({TICKS} "
          f"ticks); ms/tick mean {loop_s / TICKS * 1e3:.2f}, median "
          f"{med_tick:.2f} (20 single ticks); kernel 1 {kern_ms:.3f} "
          f"ms/solve (device time, least {k1_t['warm'][1]:.3f}; 8 "
          f"iterations, 1 launch; bound {k1_bound:.4f} ms by "
          f"{k1_by}: {k1_bytes} B, {k1_ops:.4e} ops), plain version "
          f"{plain_ms:.3f} ms/solve; launches per tick "
          f"{n1['fused_iteration'] / TICKS:.0f}; kernel share of the median "
          f"tick {kern_ms / med_tick:.4f}  ({card})", flush=True)
    print(f"[timing] kernel 1 layout: {occ['lanes']} lanes and "
          f"{occ['workspace_reals'] * 4} B of workspace per instance, "
          f"{occ['instances_per_block']} instances and "
          f"{occ['smem_per_block']} B of shared memory per block, "
          f"{occ['blocks_per_sm']} resident blocks "
          f"({occ['resident_warps_per_sm']:.0f} warps) per SM, "
          f"{occ['registers']} registers and {occ['local_bytes']} B of local "
          f"memory per thread; {kern_ms:.3f} ms/solve against a bound of "
          f"{k1_bound:.4f} ms  ({card})", flush=True)
    print(f"[timing] path 2: solves/s {B * TICKS_PATH2 / loop2_s:.1f} "
          f"({TICKS_PATH2} ticks); ms/tick mean "
          f"{loop2_s / TICKS_PATH2 * 1e3:.2f}, median {med_tick2:.2f} (20 "
          f"single ticks); kernel 2 {k2_ms:.4f} ms/launch (R={R}; bound "
          f"{k2_bound:.4f} ms by {k2_by}: {k2_bytes} B, {k2_ops:.4e} ops), "
          f"plain version {k2_plain_ms:.3f} ms; launches per tick "
          f"{n2['segment_jac'] / TICKS_PATH2:.0f}  ({card})", flush=True)
    print(f"[timing] kernel 2 layout: one thread per column, "
          f"{occ2['threads_per_block']} threads per block, "
          f"{occ2['registers']} registers and {occ2['local_bytes']} B of "
          f"local memory per thread, {occ2['blocks_per_sm']} resident "
          f"blocks ({occ2['resident_warps_per_sm']} warps) per SM against "
          f"{occ2['warps_of_work_per_sm']:.2f} warps of work per SM "
          f"({occ2['waves']} waves); "
          f"{k2_ms:.4f} ms/launch cold, {k2_warm_ms:.4f} ms/launch on the "
          f"warm linearization after tick {TICKS_PATH2} (device time: "
          f"medians of 7 rounds of 20 launches queued behind a held card; "
          f"least {k2_t['cold'][1]:.4f} and {k2_t['warm'][1]:.4f}; one "
          f"launch as the host enqueues it, by CUDA events, "
          f"{k2_host_ms:.4f} ms), against a bound of "
          f"{k2_bound:.5f} ms; "
          f"SM clock, max, power, temperature before: {clocks_before}  "
          f"({card})", flush=True)
    print(f"[timing] path 2 split per tick (x{n_it} iterations): kernel 2 "
          f"{n_it * k2_warm_ms:.3f} ms, rest of condensed_step (eager) "
          f"{n_it * (step_ms - k2_warm_ms):.2f} ms, trial evaluation (5 x "
          f"{B} folded) {n_it * trial_ms:.2f} ms, everything else "
          f"{med_tick2 - n_it * (step_ms + trial_ms):.2f} ms of the "
          f"{med_tick2:.2f} ms median tick  ({card})", flush=True)

    print(json.dumps({"kernels": [
        {
            "name": "fused_iteration",
            "route": "cuda",
            "source": "cartpole_tpu_torch/csrc/fused_iteration.cu",
            "replaces": "cartpole_tpu/ops/fused.py:938",
            "launches": n1["fused_iteration"],
            "max_abs_err": max(r_cold["max_abs_du"], r_ragged["max_abs_du"],
                               r_warm["max_abs_du"]),
            "ms": kern_ms,
            "plain_ms": plain_ms,
            "bound_ms": k1_bound,
            "bound_by": k1_by,
            "library_ms": None,
        },
        {
            "name": "segment_jac",
            "route": "cuda",
            "source": "cartpole_tpu_torch/csrc/segment_jac.cu",
            "replaces": "cartpole_tpu/ops/pallas_kernels.py:189",
            "launches": n2["segment_jac"],
            "max_abs_err": seg_err,
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
            "bound_ms": k2_bound,
            "bound_by": k2_by,
            "library_ms": None,
        },
    ]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
