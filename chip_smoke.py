#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

Drives both solve paths of ``cartpole_tpu_torch.run_closed_loop_lanes`` at
the bench point of the JAX package (single cart-pole, condensed KKT, f32,
batch 4096, window 40, spacing 5, 8 GN iterations, 5 line-search trials,
bench.py's swing-up initial states, seed 0):

* path 1, ``fused=True``: the whole solve as one launch of kernel 1
  (``csrc/fused_iteration*.cu``), ``TICKS`` ticks;
* path 2, ``fused=False``: the reference's XLA-lanes body, whose
  linearization is one launch of kernel 2 (``csrc/segment_jac*.cu``) per GN
  iteration, the rest eager torch (``TICKS_PATH2`` ticks);

and both paths for the double and the triple pole at the JAX bench's
multi-link regime (window 60, every terminal objective a soft cost,
bench.py's perturbed-upright initial states): the double through
``run_scheduled_closed_loop`` with the bench's transient weight
(``DOUBLE_SCHEDULE``), the triple through ``run_closed_loop_lanes``.

Phases, each fatal on failure: device; build (both kernels for the three
models in one library, one nvcc per source in parallel; each kernel's
registers, stack frames and spills per model, kernel 2 for each of its
step-count instantiations, none of which may spill in f32 for the single
model); segment_jac (kernel 2 against its plain version, f64 and f32, on
random columns, a ragged R that leaves the last block part full, one and
SPMAX steps per segment, and the cold-start shooting problem); kernel 1
against its plain version (cold start, and a ragged batch of RAGGED
instances that leaves the last block part full); path 1; kernel 1 against
its plain version (warm starts after tick 1 and the last tick); disturbed
(100 ticks of path 1 with a shove at the pole mass); path 2; kernel 2
against its plain version on the warm linearization after path 2's last
tick; cross (path 2 against path 1 on the cold-start problem, and path 2
under ``torch.set_float32_matmul_precision("high")``); for the double and
the triple, segment_jac and kernel 1 against their plain versions at the
regime's width, then double (path 1 through the schedule, its upright
share tick by tick against the JAX package's, path 2, and cross on the cold
problem) and triple (path 1 and path 2); timing (both
kernels by device time, ``device_ms``: kernel 1 on the warm problem after
path 1's last tick, kernel 2 on the cold and the warm problem, for every
model) and a profile of one tick of each single-model path and of the
double's and triple's path 1 (device-busy share, kernel launches), with
both kernels' launch layouts (registers, shared bytes per block, resident
blocks and warps per SM). Then the per-instance group (``MPC.step``,
``run_closed_loop``, ``vmap``; no kernel of the repo lies on it): oracle
(the ``lu`` closed loop, f64, against the C++ oracle on the host), swing-up
(the reference's 250-tick test with its gates), schur, vmap (tick 1 of
``vmap(MPC.step)`` against path 2 by path, then ``vmap(run_closed_loop)`` at
the CLI sweep's batch) and their timing (a CUDA-graph replay of a tick and
an eager tick; a replay profiled once). Then the diff group
(``make_differentiable_solve``, ``tools/sysid.py``; no kernel of the repo
lies on it either): both backward methods' f32 gradients at the point of
scripts/probe_diff_tpu.py against its f64 finite differences
(``diff_tpu_f32.json``), the f64 ``ift`` gradient against the JAX
package's (``diff_f64_jax_cpu.json``), the f32 ``ift`` under
``torch.set_float32_matmul_precision("high")``, the saturated stall of
tests/test_diff_saturation.py (``unrolled`` against central differences),
``vmap(grad)`` over the sysid states, the first sysid steps, and their
timing.
Every kernel launch counter is set to 0 just before a path is driven and
read just after. Prints the card's name and power limit beside every
number, one JSON line describing the kernels, and as its last line
``{"ok": true, "device": {...}}``.

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
import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import cartpole_tpu_torch as pt
from cartpole_tpu_torch.mpc import closed_loop as cl
from cartpole_tpu_torch.mpc import lanes
from cartpole_tpu_torch.ops import _build, fused
from cartpole_tpu_torch.ops import pallas_kernels as pk

BATCH, TICKS, TICKS_PATH2, TICKS_DISTURBED = 4096, 250, 150, 100
#: Single-tick calls whose median is the single's ms/tick.
MEDIAN_TICKS = 10
#: A batch that is not a multiple of kernel 1's instances per block, and a
#: column count that is not one of kernel 2's columns per block.
RAGGED, RAGGED_COLUMNS = 4093, 32765
#: The double- and triple-pole regime of bench.py
#: (``DOUBLE_SOFT_OPT_KWARGS``): a 0.6 s window, every terminal objective a
#: soft cost, no sinusoid kick; 8 GN iterations, spacing 5.
MULTILINK_KWARGS = dict(
    window_length=60, th_final_cost_weight=150.0,
    th_dot_final_cost_weight=10.0, b_x_dot_final_cost_weight=10.0,
    u_guess_sinusoid_amplitude=0.0, max_iterations=8, state_spacing=5,
    kkt_method="condensed")
#: bench.py's double-pole outcome run (``_double_health``) is 250 ticks:
#: an 8x u-rate weight for the first 50 cold-start ticks, then the base
#: weights. Its eager glue takes ~2.3-3.2 s a tick on the card's host
#: (~324k launches; PERF.md), so the smoke runs the schedule's first 60
#: ticks: the whole transient and 10 ticks of the base weights (100 until
#: the [diff] group's eager gradients needed the time; PERF.md §4).
DOUBLE_SCHEDULE = ((50, {"u_derivative_cost_weight": 0.8}), (10, None))
#: The JAX bench's outcome of the 250-tick run (BENCH_r05.json, TPU v5e),
#: printed beside this run's, and the gate on failed solves: the count of
#: the JAX package's unscheduled 250-tick run (knockdowns.json
#: ``n_failed_base``).
DOUBLE_REFERENCE = dict(fraction_upright=0.9956, n_failed=0)
DOUBLE_MAX_FAILED = 4
#: The upright share of the same regime tick by tick, from the JAX
#: package's lanes loop on a CPU in f32 over the first states of
#: make_x0s("double", 4096) (scripts/probe_double_upright_cpu.py): the
#: port's share at each of UPRIGHT_CHECKPOINTS must lie within
#: UPRIGHT_SIGMAS binomial standard deviations of it. After 60-100 ticks the
#: recovery is under way (the share climbs towards ~0.99 by tick 250), so
#: the curve, not one end value, is what the two runs share.
UPRIGHT_WITNESS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "double_upright_jax_cpu.json")
UPRIGHT_CHECKPOINTS, UPRIGHT_SIGMAS = (25, 50, 60), 4.0
#: The double's path 2 and the triple's paths run 3, 10 and 5 ticks (5, 30
#: and 10 before the [diff] group; PERF.md §4).
TICKS_DOUBLE_PATH2, TICKS_TRIPLE, TICKS_TRIPLE_PATH2 = 3, 10, 5
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


def make_x0s(model: str, n: int, seed: int = 0) -> np.ndarray:
    """bench.py's initial states (``make_x0s``): swing-up from hang for the
    single model, perturbed-upright disturbance rejection for the double
    and triple models."""
    rng = np.random.RandomState(seed)
    up = math.pi / 2
    if model == "triple":
        x0s = np.tile(np.array([0.0, up, up, up, 0.0, 0.0, 0.0, 0.0]),
                      (n, 1))
        x0s[:, 0] += rng.uniform(-0.2, 0.2, n)
        x0s[:, 1:4] += rng.uniform(-0.06, 0.06, (n, 3))
    elif model == "double":
        x0s = np.tile(np.array([0.0, up, up, 0.0, 0.0, 0.0]), (n, 1))
        x0s[:, 0] += rng.uniform(-0.3, 0.3, n)
        x0s[:, 1] += rng.uniform(-0.15, 0.15, n)
        x0s[:, 2] += rng.uniform(-0.1, 0.1, n)
    else:
        x0s = np.tile(np.array([0.0, -up, 0.0, 0.0]), (n, 1))
        x0s[:, 0] += rng.uniform(-0.5, 0.5, n)
        x0s[:, 1] += rng.uniform(-0.5, 0.5, n)
    return x0s


def _upright_error(th):
    """|th - pi/2| wrapped to [0, pi]."""
    return np.abs(np.mod(th - math.pi / 2 + math.pi, 2 * math.pi) - math.pi)


def upright_fraction(xf: np.ndarray, angle_indices=(1,)) -> float:
    """bench.py's definition (``_upright_fraction``): every link within 0.1
    rad of upright."""
    return float(np.mean(np.all(
        _upright_error(xf[:, list(angle_indices)]) < 0.1, axis=1)))


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


def time_cuda(fn, reps, warmup=True):
    """Mean ms per call of ``fn`` over ``reps`` calls, by CUDA events, after
    one call to warm up (which a call of seconds can do without)."""
    if warmup:
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
    """Each kernel entry of a ``ptxas -v`` log: the kernel's name and model,
    for kernel 2 its steps per segment and real type, registers, stack
    frame bytes and spill-store bytes."""
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
        m = re.search(r"(Single|Double|Triple)CartPole", line)
        e["model"] = m.group(1).lower() if m else None
        if "fused_iteration_kernel" in line:
            e["kernel"] = "fused_iteration"
        m = re.search(r"segment_jac_kernelILi(\d+)E\w*?CartPoleE([fd])E",
                      line)
        if m:
            e.update(kernel="segment_jac", sp=int(m.group(1)),
                     dtype="f32" if m.group(2) == "f" else "f64")
        out.append(e)
    return out


def build_report(entries):
    """Print both kernels' registers, stack frames and spills for every
    model (kernel 2 at sp=5 and over its step-count instantiations); fail if
    an instantiation is missing from the log, or if the single model's
    kernel 2 spills in f32."""
    for model in pk.KERNEL_MODELS:
        mine = [e for e in entries if e["model"] == model]
        for e in mine:
            if e["kernel"] == "fused_iteration":
                print(f"[build] kernel 1 (fused_iteration, {model}, "
                      f"{fused.LANES_PER_INSTANCE} lanes per instance): "
                      f"{e['registers']} registers; {e['stack']} B stack "
                      f"frame, {e['spill']} B spill stores", flush=True)
        for dtype in ("f32", "f64"):
            k2 = [e for e in mine
                  if e["kernel"] == "segment_jac" and e["dtype"] == dtype]
            if len(k2) != pk.SPMAX:
                raise SystemExit(f"[build] {len(k2)} {model} {dtype} "
                                 f"kernel-2 entries in the ptxas log, not "
                                 f"{pk.SPMAX}")
            main_sp = next(e for e in k2 if e["sp"] == 5)
            print(f"[build] kernel 2 (segment_jac, {model}, {dtype}, one "
                  f"thread per column, sp=5): {main_sp['registers']} "
                  f"registers; {main_sp['stack']} B stack frame, "
                  f"{main_sp['spill']} B spill stores; over "
                  f"sp=1..{pk.SPMAX}: {min(e['registers'] for e in k2)}-"
                  f"{max(e['registers'] for e in k2)} registers, stack "
                  f"frames up to {max(e['stack'] for e in k2)} B, spill "
                  f"stores up to {max(e['spill'] for e in k2)} B",
                  flush=True)
            if (model == "single" and dtype == "f32"
                    and any(e["spill"] for e in k2)):
                raise SystemExit("[build] kernel 2 spills in f32")
    if not any(e["kernel"] == "fused_iteration" for e in entries):
        raise SystemExit("[build] no kernel-1 entry in the ptxas log")


def time_host(fn, reps):
    """Mean ms per synchronised call of ``fn`` by the host clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


#: Host calls that launch work on the card, as the profiler names them.
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cudaGraphLaunch")


def profile_calls(fn, n=1):
    """``n`` calls of ``fn`` under ``torch.profiler``: wall ms, device-busy
    ms (sum of the kernels', copies' and fills' device time), launches
    from the host (a graph replay is one) and operations on the device,
    per call. Reads the profiler's raw events: a double-pole tick has ~1M
    of them, which ``key_averages`` takes a minute or more to aggregate."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.profiler.kineto_results.events()
    # Event durations are in ns in newer releases of torch, in us in older.
    dur_us = ((lambda e: e.duration_ns() / 1e3)
              if events and hasattr(events[0], "duration_ns")
              else (lambda e: e.duration_us()))
    busy_us, launches, device_ops = 0.0, 0, 0
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            busy_us += dur_us(e)
            device_ops += 1
        elif e.name() in LAUNCHES:
            launches += 1
    return dict(wall_ms=wall / n, device_busy_ms=busy_us / 1e3 / n,
                device_idle_share=1 - busy_us / 1e3 / wall,
                launches=launches / n, device_ops=device_ops / n)


def profile_ticks(mpc, dp, x, mst, fused_flag, n=1):
    """``profile_calls`` of ``n`` warm lanes ticks, each from the last."""
    carry = [x, mst]

    def tick():
        r = pt.run_closed_loop_lanes(mpc, carry[0], dp, 1,
                                     mpc_state=carry[1], fused=fused_flag)
        carry[:] = [r.final_state, r.final_mpc_state]

    return profile_calls(tick, n)


# ------------------------------------------------------------- kernel 2
def segment_inputs_random(R, sp, dev, seed=0, model=pt.SINGLE_CARTPOLE):
    """Random columns of ``model``: positions in [-1, 1], angles in [-4,
    4], base velocity in [-3, 3], angle rates in [-8, 8], controls in [-10,
    10], the model's default params; f64."""
    rng = np.random.RandomState(seed)
    n_q = model.state_dim // 2
    scale = [1.0] + [4.0] * (n_q - 1) + [3.0] + [8.0] * (n_q - 1)
    xs = rng.uniform(-1, 1, (model.state_dim, R)) * np.array(scale)[:, None]
    us = rng.uniform(-10, 10, (sp, R))
    dp = model.params_type().to(torch.float64, dev)
    p = fused.params_block(dp, R, torch.float64, dev)
    return p, torch.as_tensor(xs, device=dev), torch.as_tensor(us, device=dev)


def segment_inputs_problem(problem, Z):
    """The linearization inputs of ``condensed_step``, in f64."""
    x_start, useg = problem._fold_segments(Z)
    p = lanes._fold_lanes(fused.params_block(
        problem.dynamics_params, problem.B, Z.u.dtype, Z.u.device),
        problem.S, problem.B)
    return tuple(t.double().contiguous() for t in (p, x_start, useg))


def check_segment_jac(tag, inputs, h, card, model=pt.SINGLE_CARTPOLE):
    """Kernel 2 of ``model`` against its plain version on the same inputs:
    f64 kernel vs f64 plain within 1e-12 x max(1, |value|) on every output;
    f32 kernel vs f64 plain at most twice the f32 plain version's error
    (99.9th percentile over columns of each output's worst element)."""
    angle = model.angle_indices
    phase = ("segment_jac" if model.name == "single"
             else f"segment_jac {model.name}")
    p64, x64, u64 = inputs
    k64 = pk.segment_jac_batch_last(p64, x64, u64, h, angle, model)
    ref = pk.segment_jac_batch_last_reference(p64, x64, u64, h, angle,
                                              model)
    f32 = tuple(t.float() for t in inputs)
    k32 = pk.segment_jac_batch_last(*f32, h, angle, model)
    p32 = pk.segment_jac_batch_last_reference(*f32, h, angle, model)
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
    print(f"[{phase}] {tag}, R={x64.shape[1]}, sp={u64.shape[0]}: "
          f"{json.dumps(out)}; f32 kernel vs f32 plain max abs "
          f"{max_abs:.3e}  ({card})", flush=True)
    if not ok:
        raise SystemExit(f"[{phase}] {tag}: kernel disagrees with its "
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


def _relative(err, scale):
    """``err / scale``; 0 where both are 0 (every agreeing instance kept
    u = 0: no step was accepted), inf where only the scale is."""
    if scale > 0:
        return err / scale
    return 0.0 if err == 0 else math.inf


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
        rel_du=_relative(max_abs_du, float(b["u"][:, agree].abs().mean())),
    )


def setup_problem(mpc, state, x, dtype):
    dp = mpc.model.params_type().to(dtype, x.device)
    st = pt.MPCState(state.previous_solution.to(dtype), state.warm)
    problem, Z0 = lanes._prepare(mpc, st, x.to(dtype), dp)
    return problem, Z0


def compare(mpc, state, x, nudge=None):
    """Kernel 1 (one launch, n_iter iterations) against the plain version
    (n_iter calls of fused_iteration_reference) on the problem of one tick,
    both on the card in f32; n_iter launches of one iteration against the
    one launch; and both f32 results against the plain version in f64 (the
    accuracy f32 allows). With ``nudge``, also the plain version against
    itself with its initial guess moved by one ulp: the rounding-noise
    floor of the termination decisions. ``nudge="u"`` moves the controls;
    ``"xs+u"`` also the shooting states, for a cold start whose controls
    are all 0 (a one-ulp move of 0 changes no decision)."""
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
        def up(t):
            return torch.nextafter(t, torch.full_like(t, math.inf))

        xs1 = up(carry0[0]) if nudge == "xs+u" else carry0[0]
        cn, tn = _plain_solve(args, (xs1, up(carry0[1])) + carry0[2:],
                              n_iter)
        out["plain_vs_nudged_plain"] = _agreement(path_of(cn, tn),
                                                  path_of(cp, tp))
    return out


def check_compare(tag, r, gate, card, phase=None, floor=None):
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
    * ``"floor"`` (the double's and triple's cold starts): the noise gate
      against the plain version's agreement with itself after a one-ulp
      nudge of its shooting states and controls (``floor``, or measured in
      ``r``); over the agreeing instances max |du| / mean |u| at most
      max(1e-3, twice the plain version's against its nudged self); and
      the strict gate's accuracy against f64. Their line-search decisions,
      and their controls along the flat directions of the soft terminal
      costs, sit at f32 rounding noise from the first tick (PERF.md,
      section 6).
    """
    head = f"[{phase}] {tag}" if phase else f"[{tag}]"
    print(f"{head} kernel vs plain: {json.dumps(r)}  ({card})", flush=True)
    ident = r["identical_fraction"]
    v = r["vs_f64"]
    if floor is None:
        floor = r.get("plain_vs_nudged_plain")
    if gate == "noise":
        ok = ident >= floor["identical_fraction"] - 0.02
    elif gate == "floor":
        ok = (floor_ok(r, floor)
              and v["kernel_err"]["p999"] <= 2 * v["plain_err"]["p999"])
    else:
        ok = (ident >= 0.999 and r["rel_du"] <= 1e-3
              and v["kernel_err"]["p999"] <= 2 * v["plain_err"]["p999"])
    if not (ok and r["split_launch_identical"]):
        raise SystemExit(f"{head} kernel disagrees with its plain version")


def floor_ok(r, floor):
    """``r`` (an ``_agreement``) against the plain version's agreement
    with itself after a one-ulp nudge: the same-path share within 2 points
    of it, and max |du| / mean |u| over the agreeing instances at most
    max(1e-3, twice its)."""
    return (r["identical_fraction"] >= floor["identical_fraction"] - 0.02
            and r["rel_du"] <= max(1e-3, 2 * floor["rel_du"]))


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


# ------------------------------------------------------- double and triple
def multilink_mpc(model):
    return pt.make_mpc(pt.OptimizationParams(**MULTILINK_KWARGS), model)


def cold_state(mpc, B, dev):
    return pt.MPCState(
        previous_solution=torch.zeros((B, mpc.spec.dim), device=dev),
        warm=torch.zeros((B,), dtype=torch.bool, device=dev))


def check_multilink_kernels(model, dev, card):
    """[segment_jac <model>] and [kernel 1 <model>]: both kernels against
    their plain versions at the regime's width (R = S x B columns of sp = 5
    steps, and one and SPMAX steps; a ragged R; the cold-start shooting
    problem; kernel 1 on the cold problem at B and at a ragged batch).
    Returns the cold problem's kernel-2 inputs and the largest errors."""
    mpc = multilink_mpc(model)
    B, h = BATCH, mpc.params.control_dt
    S, sp = mpc.spec.num_states - 1, mpc.spec.spacing
    R = S * B
    check_segment_jac("random columns, seed 0", segment_inputs_random(
        R, sp, dev, model=model), h, card, model)
    check_segment_jac("random columns, ragged", segment_inputs_random(
        R - 3, sp, dev, seed=1, model=model), h, card, model)
    for n_steps in (1, pk.SPMAX):
        check_segment_jac(f"random columns, sp={n_steps}",
                          segment_inputs_random(R, n_steps, dev, seed=2,
                                                model=model), h, card, model)
    x0 = torch.as_tensor(make_x0s(model.name, B), dtype=torch.float32,
                         device=dev)
    cold = cold_state(mpc, B, dev)
    seg_cold = segment_inputs_problem(*setup_problem(mpc, cold, x0,
                                                     torch.float64))
    seg_err = check_segment_jac("cold-start shooting problem", seg_cold, h,
                                card, model)
    phase = f"kernel 1 {model.name}"
    r_cold = compare(mpc, cold, x0, nudge="xs+u")
    check_compare("cold, tick 0", r_cold, "floor", card, phase)
    floor = r_cold["plain_vs_nudged_plain"]
    # The ragged batch is the cold problem less its last instances: its
    # floor is the cold problem's.
    r_ragged = compare(mpc, pt.MPCState(cold.previous_solution[:RAGGED],
                                        cold.warm[:RAGGED]), x0[:RAGGED])
    check_compare(f"cold, tick 0, ragged batch {RAGGED}", r_ragged, "floor",
                  card, phase, floor)
    return dict(seg_cold=seg_cold, seg_err=seg_err,
                k1_err=max(r_cold["max_abs_du"], r_ragged["max_abs_du"]),
                floor=floor)


def run_loop(tag, model, mpc, fn, ticks, fused_flag, card):
    """Drive ``fn()`` (a closed loop of ``ticks`` ticks) with the launch
    counts set to 0 just before and read just after; check that it ran one
    kernel-1 launch a tick on path 1 and one kernel-2 launch a GN iteration
    on path 2 and nothing else, and that every state and control is finite.
    Returns ``(result, seconds, launches, n_failed, fraction_upright)``."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = counts()
    failed = n_failed([res])
    up = upright_fraction(res.final_state.cpu().numpy(), model.angle_indices)
    finite = bool(torch.isfinite(res.states).all()
                  and torch.isfinite(res.controls).all()
                  and torch.isfinite(res.final_state).all())
    print(f"[{tag}] fused={fused_flag}, {ticks} ticks x batch "
          f"{res.states.shape[0]}: {secs:.2f} s, launches {n}, n_failed "
          f"{failed}, fraction_upright {up:.4f}, finite {finite}  ({card})",
          flush=True)
    want = ({"fused_iteration": ticks, "segment_jac": 0} if fused_flag else
            {"fused_iteration": 0,
             "segment_jac": ticks * mpc.nls_config.max_iterations})
    if n != want:
        raise SystemExit(f"[{tag}] launches {n}, not {want}")
    if not finite:
        raise SystemExit(f"[{tag}] non-finite states or controls")
    return res, secs, n, failed, up


def upright_witness():
    """The JAX package's upright share of the double's regime, tick by
    tick (``UPRIGHT_WITNESS``)."""
    with open(UPRIGHT_WITNESS) as f:
        w = json.load(f)
    if w["schedule"][0] != list(DOUBLE_SCHEDULE[0]):
        raise SystemExit(f"[double] {UPRIGHT_WITNESS} ran another "
                         f"transient: {w['schedule'][0]}")
    return w


def check_upright_curve(res, model, card):
    """The port's upright share at each of ``UPRIGHT_CHECKPOINTS`` against
    the JAX package's (``upright_witness``): within ``UPRIGHT_SIGMAS``
    standard deviations of the difference of two binomial shares of their
    batches. Also prints the port's share over the witness's instances
    (the same initial states)."""
    w = upright_witness()
    states = torch.cat([res.states, res.final_state[:, None]], 1)
    angles = states[..., list(model.angle_indices)].cpu().numpy()
    up = np.all(_upright_error(angles) < 0.1, axis=-1)  # (B, T + 1)
    n_port, n_ref = up.shape[0], w["batch"]
    rows, ok = [], True
    for t in UPRIGHT_CHECKPOINTS:
        p_ref, p_port = w["upright_by_tick"][t], float(up[:, t].mean())
        q = min(max(p_ref, 1 / n_ref), 1 - 1 / n_ref)
        tol = UPRIGHT_SIGMAS * math.sqrt(q * (1 - q)
                                         * (1 / n_ref + 1 / n_port))
        ok &= abs(p_port - p_ref) <= tol
        rows.append(dict(tick=t, port=p_port,
                         port_same_states=float(up[:n_ref, t].mean()),
                         jax_cpu=p_ref, tol=tol))
    print(f"[double] upright share by tick, the port (batch {n_port}) "
          f"against the JAX package's lanes loop (CPU, f32, the first "
          f"{n_ref} of the same states; {w['script']}), gate |port - jax| "
          f"<= {UPRIGHT_SIGMAS:g} sigma: {json.dumps(rows)}  ({card})",
          flush=True)
    if not ok:
        raise SystemExit("[double] the upright share departs from the JAX "
                         "package's")


def run_double(dev, card, floor):
    """[double]: bench.py's double-pole outcome run on path 1 through
    ``run_scheduled_closed_loop`` (its first 60 ticks), with its upright
    share tick by tick against the JAX package's; then the first ticks of
    the same schedule on path 2, and [cross] path 2 against path 1 on the
    cold problem, against ``floor``: the plain version's agreement with
    itself on that problem after a one-ulp nudge
    (``check_multilink_kernels``)."""
    model = pt.DOUBLE_CARTPOLE
    mpc = multilink_mpc(model)
    B = BATCH
    dp = model.params_type().to(torch.float32, dev)
    x0 = torch.as_tensor(make_x0s("double", B), dtype=torch.float32,
                         device=dev)
    ticks = sum(n for n, _ in DOUBLE_SCHEDULE)
    res, secs, n1, failed, up = run_loop(
        "double", model, mpc, lambda: pt.run_scheduled_closed_loop(
            mpc, x0, dp, DOUBLE_SCHEDULE, layout="lanes", fused=True),
        ticks, True, card)
    print(f"[double] schedule {json.dumps(DOUBLE_SCHEDULE)}: "
          f"fraction_upright {up:.4f}, n_failed {failed} (gate <= "
          f"{DOUBLE_MAX_FAILED}); the JAX bench's 250-tick run of this "
          f"regime: {json.dumps(DOUBLE_REFERENCE)} (TPU v5e, "
          f"BENCH_r05.json); outcomes, not times  ({card})", flush=True)
    if failed > DOUBLE_MAX_FAILED:
        raise SystemExit("[double] n_failed out of bounds")
    check_upright_curve(res, model, card)
    first = ((TICKS_DOUBLE_PATH2, DOUBLE_SCHEDULE[0][1]),)
    res2, secs2, n2, _, _ = run_loop(
        "double", model, mpc, lambda: pt.run_scheduled_closed_loop(
            mpc, x0, dp, first, layout="lanes", fused=False),
        TICKS_DOUBLE_PATH2, False, card)

    problem32, Z0_32 = setup_problem(mpc, cold_state(mpc, B, dev), x0,
                                     torch.float32)
    cfg = mpc.nls_config
    Za, oa = lanes._solve_lanes(problem32, Z0_32, cfg, fused=False)
    Zb, ob = lanes._solve_lanes(problem32, Z0_32, cfg, fused=True)
    cross = _agreement(path_of_outputs(Za, oa), path_of_outputs(Zb, ob))
    print(f"[cross] double: path 2 vs path 1, cold start, batch {B}, f32: "
          f"{json.dumps(cross)}; the plain version against itself after a "
          f"one-ulp nudge: {json.dumps(floor)}  ({card})", flush=True)
    if not floor_ok(cross, floor):
        raise SystemExit("[cross] double: path 2 disagrees with path 1")
    return dict(mpc=mpc, dp=dp, res=res, secs=secs, ticks=ticks, n1=n1,
                res2=res2, secs2=secs2, n2=n2)


def run_triple(dev, card):
    """[triple]: path 1 and path 2 from bench.py's perturbed-upright
    triple-pole states. No upright gate: these perturbations lie outside
    this configuration's region of attraction (tests/test_triple.py)."""
    model = pt.TRIPLE_CARTPOLE
    mpc = multilink_mpc(model)
    dp = model.params_type().to(torch.float32, dev)
    x0 = torch.as_tensor(make_x0s("triple", BATCH), dtype=torch.float32,
                         device=dev)
    res, secs, n1, _, _ = run_loop(
        "triple", model, mpc, lambda: pt.run_closed_loop_lanes(
            mpc, x0, dp, TICKS_TRIPLE, fused=True), TICKS_TRIPLE, True, card)
    res2, secs2, n2, _, _ = run_loop(
        "triple", model, mpc, lambda: pt.run_closed_loop_lanes(
            mpc, x0, dp, TICKS_TRIPLE_PATH2, fused=False),
        TICKS_TRIPLE_PATH2, False, card)
    return dict(mpc=mpc, dp=dp, res=res, secs=secs, ticks=TICKS_TRIPLE,
                n1=n1, res2=res2, secs2=secs2, n2=n2)


def time_multilink(model, run, checks, card, median_ticks=3):
    """[timing] of one model: kernel 1 per solve on the warm problem after
    path 1's last tick and kernel 2 per launch on the cold problem (device
    time), their bounds on this run's data, their plain versions, the
    launch layouts, launches per tick and the median path-1 tick. Returns
    the two entries of the kernels line."""
    mpc, dp, res = run["mpc"], run["dp"], run["res"]
    cfg, B = mpc.nls_config, BATCH
    h, angle = mpc.params.control_dt, model.angle_indices
    ms = []
    x, mst = res.final_state, res.final_mpc_state
    for _ in range(median_ticks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r1 = pt.run_closed_loop_lanes(mpc, x, dp, 1, mpc_state=mst,
                                      fused=True)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        x, mst = r1.final_state, r1.final_mpc_state
    med_tick = float(np.median(ms))
    prof = profile_ticks(mpc, dp, x, mst, True)

    problem_w, Z0_w = lanes._prepare(mpc, res.final_mpc_state,
                                     res.final_state, dp)
    st = problem_w.statics.fused
    wargs = (st, dp, problem_w.x_current, problem_w.set_point,
             problem_w.u_prev)
    carry_w = lanes._init_carry(Z0_w, cfg)
    k1_t = device_ms({"warm": lambda: fused.fused_solve(
        *wargs, carry_w, cfg.max_iterations)}, reps=5)
    k1_ms = k1_t["warm"][0]
    k1_plain = time_cuda(
        lambda: _plain_solve(wargs, carry_w, cfg.max_iterations), 1,
        warmup=False)
    _, _, _, io = fused.kernel_io(*wargs, *carry_w, cfg.max_iterations)
    k1_bytes = sum(t.numel() * t.element_size() for t in io.values())
    del io
    _, t_w = fused.fused_solve(*wargs, carry_w, cfg.max_iterations)
    k1_ops = kernel1_ops(st, wargs, carry_w, t_w)
    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    occ = fused.kernel_occupancy(st, B)

    seg32 = tuple(t.float() for t in checks["seg_cold"])
    R, sp = seg32[1].shape[1], seg32[2].shape[0]
    k2_t = device_ms({"cold": lambda: pk.segment_jac_batch_last(
        *seg32, h, angle, model)})
    k2_ms = k2_t["cold"][0]
    k2_plain = time_cuda(lambda: pk.segment_jac_batch_last_reference(
        *seg32, h, angle, model), 3)
    outs = pk.segment_jac_batch_last(*seg32, h, angle, model)
    k2_bytes = sum(t.numel() * t.element_size() for t in seg32 + outs)
    k2_ops = count_ops(lambda: pk.segment_jac_batch_last_reference(
        *seg32, h, angle, model))
    k2_bound, k2_by = bound(k2_bytes, k2_ops)
    occ2 = pk.kernel_occupancy(R, sp, model=model)
    name = model.name
    ticks2 = run["n2"]["segment_jac"] // cfg.max_iterations
    print(f"[timing] {name}: path 1 {run['ticks']} ticks in "
          f"{run['secs']:.2f} s, median tick {med_tick:.2f} ms "
          f"({median_ticks} single ticks), "
          f"{run['n1']['fused_iteration'] / run['ticks']:.0f} kernel-1 "
          f"launch a tick; path 2 {ticks2} ticks in {run['secs2']:.2f} s, "
          f"{run['n2']['segment_jac'] / ticks2:.0f} kernel-2 launches a "
          f"tick; one warm path-1 tick under torch.profiler: "
          f"{json.dumps(prof)}  ({card})", flush=True)
    print(f"[timing] {name}: kernel 1 {k1_ms:.3f} ms/solve (device time, "
          f"least {k1_t['warm'][1]:.3f}; warm problem after path 1's last "
          f"tick; bound {k1_bound:.4f} ms by {k1_by}: {k1_bytes} B, "
          f"{k1_ops:.4e} ops), plain version {k1_plain:.3f} ms; layout "
          f"{json.dumps(occ)}  ({card})", flush=True)
    print(f"[timing] {name}: kernel 2 {k2_ms:.4f} ms/launch (device time, "
          f"least {k2_t['cold'][1]:.4f}; cold problem, R={R}, sp={sp}; "
          f"bound {k2_bound:.5f} ms by {k2_by}: {k2_bytes} B, "
          f"{k2_ops:.4e} ops), plain version {k2_plain:.3f} ms; layout "
          f"{json.dumps(occ2)}  ({card})", flush=True)
    return [
        {"name": f"fused_iteration:{name}", "route": "cuda",
         "source": "cartpole_tpu_torch/csrc/fused_iteration_launch.cuh",
         "replaces": "cartpole_tpu/ops/fused.py:938",
         "launches": run["n1"]["fused_iteration"],
         "max_abs_err": checks["k1_err"], "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        {"name": f"segment_jac:{name}", "route": "cuda",
         "source": "cartpole_tpu_torch/csrc/segment_jac_launch.cuh",
         "replaces": "cartpole_tpu/ops/pallas_kernels.py:189",
         "launches": run["n2"]["segment_jac"],
         "max_abs_err": checks["seg_err"], "ms": k2_ms, "plain_ms": k2_plain,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None},
    ]


# ------------------------------------------------------- per-instance path
#: The per-instance phases (``MPC.step``, ``run_closed_loop``, ``vmap``):
#: the JAX package's closed-loop test configuration (tests/test_native.py,
#: tests/test_closed_loop.py, tests/test_schur.py: window 40, spacing 5, 10
#: GN iterations, f64, from the hanging pole), and the CLI sweep's (cli.py
#: ``sweep --layout vmap``: the default params, batch 256, hanging poles
#: moved by up to 0.3 in b_x and theta from seed 0, f32).
#: The schur path runs 50 ticks gated on its codes and controls, and the
#: vmap run 25 ticks, not 250 and 100, to hold the smoke's time (PERF.md
#: §4; 100 and 50 before the [diff] group).
DOWN = (0.0, -math.pi / 2, 0.0, 0.0)
TICKS_ORACLE, TICKS_SWINGUP, TICKS_SCHUR, TICKS_VMAP = 100, 250, 50, 25
VMAP_BATCH = 256
#: tests/test_native.py:145-153: |u - u_oracle| and the states' atol.
ORACLE_DU, ORACLE_DX = 1e-4, 1e-5


def oracle_gate(u, states, u_ref, states_ref):
    """The port's lu closed loop against the C++ oracle's (numpy arrays):
    max |du| <= ORACLE_DU and the states within ``np.allclose(...,
    atol=ORACLE_DX)``, as tests/test_native.py holds the JAX package."""
    du = float(np.abs(u - u_ref).max())
    dx = float(np.abs(states - states_ref).max())
    ok = du <= ORACLE_DU and bool(np.allclose(states, states_ref,
                                              atol=ORACLE_DX))
    return dict(max_abs_du=du, max_abs_dx=dx, ok=bool(ok))


def health_gate(codes, controls):
    """No QP_INDEFINITE or MAX_LAMBDA code, and |u| <= 300 (numpy
    arrays)."""
    checks = dict(
        no_failed_solve=not bool(np.any((codes == 3) | (codes == 4))),
        controls_within_limit=bool(np.all(np.abs(controls)
                                          <= 300.0 + 1e-12)))
    return dict(checks, ok=all(checks.values()),
                max_abs_u=float(np.abs(controls).max()))


def swingup_gate(codes, terminal_predictions, final_state, violations,
                 controls):
    """The swing-up gates of tests/test_closed_loop.py:44-75 on one run
    (numpy arrays): ``health_gate``; after tick 20 every terminal
    prediction upright (theta, b_x_dot and theta_dot within 1e-4) and the
    violation below 1e-4; the final state upright within 1e-4 / 1e-4 /
    1e-3."""
    tp = terminal_predictions[21:]
    tp_err = max(np.abs(tp[:, 1] - math.pi / 2).max(),
                 np.abs(tp[:, 2]).max(), np.abs(tp[:, 3]).max())
    xf = final_state
    final = (abs(xf[1] - math.pi / 2), abs(xf[2]), abs(xf[3]))
    health = health_gate(codes, controls)
    checks = dict(
        no_failed_solve=health["no_failed_solve"],
        terminal_upright_after_tick_20=bool(tp_err < 1e-4),
        final_upright=bool(final[0] < 1e-4 and final[1] < 1e-4
                           and final[2] < 1e-3),
        violation_after_tick_20=bool(violations[21:].max() < 1e-4),
        controls_within_limit=health["controls_within_limit"],
    )
    return dict(checks, ok=all(checks.values()),
                terminal_error=float(tp_err),
                final_error=[float(v) for v in final],
                max_violation_after_tick_20=float(violations[21:].max()),
                max_abs_u=health["max_abs_u"])


def sweep_x0s(n, seed=0):
    """cli.py's ``sweep`` states for the single model: hanging, b_x and
    theta moved by uniform draws in [-0.3, 0.3]."""
    rng = np.random.RandomState(seed)
    x0s = np.tile(np.array(DOWN), (n, 1))
    x0s[:, 0] += rng.uniform(-0.3, 0.3, n)
    x0s[:, 1] += rng.uniform(-0.3, 0.3, n)
    return x0s


def vmap_agreement(mpc, x0s, dp):
    """The first tick's solve of ``vmap(MPC.step)`` against path 2
    (``step_lanes(..., fused=False)``, which launches kernel 2) on the same
    cold states, by path (``_agreement``), and path 2 against itself with
    its initial shooting states and controls moved up one ulp (its floor).
    """
    B = x0s.shape[0]
    cold = pt.MPCState(
        torch.zeros((B, mpc.spec.dim), dtype=x0s.dtype, device=x0s.device),
        torch.zeros((B,), dtype=torch.bool, device=x0s.device))
    out_pi, _ = torch.func.vmap(lambda st, x: mpc.step(st, x, dp))(cold, x0s)
    out_l2, _ = pt.step_lanes(mpc, cold, x0s, dp, fused=False)

    def path(out):
        return dict(term=out.solver.termination_state,
                    iters=out.solver.n_iterations,
                    alpha=out.solver.iter_step_size.T, u=out.u.T)

    r = _agreement(path(out_pi), path(out_l2))
    problem, Z0 = lanes._prepare(mpc, cold, x0s, dp)

    def up(t):
        return torch.nextafter(t, torch.full_like(t, math.inf))

    Za, oa = lanes._solve_lanes(problem, Z0, mpc.nls_config, fused=False)
    Zb, ob = lanes._solve_lanes(problem, lanes._Z(up(Z0.xs), up(Z0.u)),
                                mpc.nls_config, fused=False)
    r["path2_vs_nudged_path2"] = _agreement(path_of_outputs(Zb, ob),
                                            path_of_outputs(Za, oa))
    return r


def vmap_agreement_ok(r):
    """The strict gate (>= 99.9 % on the same path, max |du| / mean |u| <=
    1e-3) where path 2's own one-ulp floor meets it; else the floor gate
    (``floor_ok``). Returns ``(ok, gate name)``."""
    floor = r["path2_vs_nudged_path2"]
    if floor["identical_fraction"] >= 0.999 and floor["rel_du"] <= 1e-3:
        return (r["identical_fraction"] >= 0.999 and r["rel_du"] <= 1e-3,
                "strict")
    return floor_ok(r, floor), "floor"


def tick_ms(fn, n):
    """Wall ms of each of ``n`` synchronised calls of ``fn``."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def time_per_instance(mpc, dp, carry, n=10, eager=False):
    """A warm tick of ``run_closed_loop`` from ``carry`` (x,
    previous_solution, warm): the median ms of ``n`` replays of its CUDA
    graph and one replay under ``torch.profiler`` (its device operations
    are the kernels an eager tick launches one by one); with ``eager``,
    also one eager tick (``closed_loop_step`` as the host launches it)
    timed, and whether the replay gives the eager tick's bits. Runs under
    ``vmap`` as well."""
    tick = cl.tick_fn(mpc, dp, 0.0)
    graph = cl.CUDAGraphTick(tick, carry)
    out = dict(graph_ms=float(np.median(tick_ms(lambda: graph(*carry), n))),
               graph_profile=profile_calls(lambda: graph(*carry)))
    if eager:
        out.update(eager_ms=tick_ms(lambda: tick(*carry), 1)[0],
                   replay_bit_identical=all(
                       torch.equal(a, b) for a, b in zip(graph(*carry),
                                                         tick(*carry))))
    return out


def run_per_instance(dev, card):
    """[per-instance]: [oracle], [swing-up], [schur], [vmap] and their
    [timing]; each phase is fatal on failure. No kernel of the repo lies on
    this path: the counts must stay 0 (the comparison with path 2 in
    [vmap] launches kernel 2 outside the counted runs)."""
    from cartpole_tpu_torch import native

    t_group = time.perf_counter()

    def phase_done(tag):
        print(f"[per-instance] {time.perf_counter() - t_group:.1f} s after "
              f"{tag}", flush=True)

    f64 = torch.float64
    x_down = torch.tensor(DOWN, dtype=f64, device=dev)
    dp64 = pt.default_single_params(f64, dev)

    def drive(tag, mpc, x, dp, ticks):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = pt.run_closed_loop(mpc, x, dp, ticks)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if any(counts().values()):
            raise SystemExit(f"[{tag}] launched a kernel of the repo: "
                             f"{counts()}")
        return res, secs

    # ------------------------------------------------------------- oracle
    opt = pt.OptimizationParams(max_iterations=10, state_spacing=5,
                                kkt_method="lu")
    mpc_lu = pt.make_mpc(opt)
    res, secs = drive("oracle", mpc_lu, x_down, dp64, TICKS_ORACLE)
    u_ref, states_ref = native.oracle_closed_loop(
        pt.SingleCartPoleParams(), opt, np.array(DOWN), TICKS_ORACLE)
    g = oracle_gate(res.controls.cpu().numpy(), res.states.cpu().numpy(),
                    u_ref, states_ref)
    print(f"[oracle] lu, f64, KKT {mpc_lu.spec.dim + mpc_lu.spec.n_eq}x"
          f"{mpc_lu.spec.dim + mpc_lu.spec.n_eq}, {TICKS_ORACLE} ticks of "
          f"run_closed_loop from the hanging pole: {secs:.2f} s; against "
          f"native/oracle.cc on the host: {json.dumps(g)}, gate max |du| <= "
          f"{ORACLE_DU:g}, states atol {ORACLE_DX:g}  ({card})", flush=True)
    if not g["ok"]:
        raise SystemExit("[oracle] the lu closed loop departs from the "
                         "C++ oracle")
    phase_done("oracle")

    # ----------------------------------------------- swing-up and schur
    runs = {}
    for tag, kkt, ticks in (("swing-up", "condensed", TICKS_SWINGUP),
                            ("schur", "schur", TICKS_SCHUR)):
        mpc = pt.make_mpc(pt.OptimizationParams(
            max_iterations=10, state_spacing=5, kkt_method=kkt))
        res, secs = drive(tag, mpc, x_down, dp64, ticks)
        arrs = {k: getattr(res, k).cpu().numpy() for k in (
            "termination_states", "terminal_predictions", "final_state",
            "constraint_violations", "controls")}
        if tag == "swing-up":
            g, gates = swingup_gate(*arrs.values()), \
                "tests/test_closed_loop.py"
        else:
            g, gates = health_gate(arrs["termination_states"],
                                   arrs["controls"]), "codes and |u|"
        codes = np.bincount(arrs["termination_states"], minlength=5)
        print(f"[{tag}] {kkt}, f64, {ticks} ticks of run_closed_loop from "
              f"the hanging pole: {secs:.2f} s, termination codes "
              f"{codes.tolist()}; gates of {gates}: {json.dumps(g)}  "
              f"({card})", flush=True)
        if not g["ok"]:
            raise SystemExit(f"[{tag}] its gates failed")
        runs[tag] = (mpc, res)
        phase_done(tag)

    # --------------------------------------------------------------- vmap
    mpc32 = pt.make_mpc(pt.OptimizationParams())
    dp32 = pt.default_single_params(torch.float32, dev)
    x0s = torch.as_tensor(sweep_x0s(VMAP_BATCH), dtype=torch.float32,
                          device=dev)
    r = vmap_agreement(mpc32, x0s, dp32)
    ok, gate = vmap_agreement_ok(r)
    print(f"[vmap] tick 1, vmap(MPC.step) against path 2 (step_lanes, "
          f"fused=False) on the same {VMAP_BATCH} cold states, f32, gate "
          f"{gate}: {json.dumps(r)}  ({card})", flush=True)
    if not ok:
        raise SystemExit("[vmap] the per-instance solve departs from path 2")
    phase_done("vmap agreement")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = torch.func.vmap(
        lambda x: pt.run_closed_loop(mpc32, x, dp32, TICKS_VMAP))(x0s)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if any(counts().values()):
        raise SystemExit(f"[vmap] launched a kernel of the repo: {counts()}")
    failed = n_failed([res])
    finite = bool(torch.isfinite(res.states).all()
                  and torch.isfinite(res.final_state).all())
    up = upright_fraction(res.final_state.cpu().numpy())
    print(f"[vmap] torch.func.vmap(run_closed_loop), batch {VMAP_BATCH}, "
          f"{TICKS_VMAP} ticks, f32, default params: {secs:.2f} s, n_failed "
          f"{failed}, finite {finite}, fraction_upright at tick "
          f"{TICKS_VMAP} {up:.4f}  ({card})", flush=True)
    if failed or not finite:
        raise SystemExit("[vmap] failed solves or non-finite states")
    phase_done("vmap")

    # ------------------------------------------------------------- timing
    mpc, res_s = runs["swing-up"]
    carry64 = (res_s.final_state, res_s.final_mpc_state.previous_solution,
               res_s.final_mpc_state.warm)
    dp32_s = pt.default_single_params(torch.float32, dev)
    timing = {
        "single f64": time_per_instance(mpc, dp64, carry64, eager=True),
        "single f32": time_per_instance(
            mpc, dp32_s, tuple(c.float() if c.is_floating_point() else c
                               for c in carry64)),
    }
    box = []
    torch.func.vmap(lambda *c: box.append(time_per_instance(
        mpc32, dp32, c)) or c[0])(
        res.final_state, res.final_mpc_state.previous_solution,
        res.final_mpc_state.warm)
    timing[f"vmap B={VMAP_BATCH} f32 (default params)"] = box[0]
    for name, t in timing.items():
        eager = (f"; one eager tick {t['eager_ms']:.2f} ms; the replay "
                 f"gives the eager tick's bits: {t['replay_bit_identical']}"
                 if "eager_ms" in t else "")
        print(f"[timing] per-instance, {name}, a warm tick of "
              f"run_closed_loop: {t['graph_ms']:.2f} ms median of 10 "
              f"replays of its CUDA graph, one under torch.profiler "
              f"{json.dumps(t['graph_profile'])}{eager}  ({card})",
              flush=True)
    print(f"[per-instance] {time.perf_counter() - t_group:.1f} s for the "
          f"group  ({card})", flush=True)
    if not timing["single f64"]["replay_bit_identical"]:
        raise SystemExit("[timing] the CUDA-graph replay of a tick departs "
                         "from the eager tick")


# --------------------------------------------------- the differentiable solve
#: The point of scripts/probe_diff_tpu.py, the reference's on-chip gate of
#: make_differentiable_solve: the default window 40, spacing 5, condensed,
#: 12 GN iterations, f32, L = sum(u*^2) from DIFF_X0. Its f64 central
#: differences on a CPU (diff_tpu_f32.json's fd_f64_cpu) are the witness;
#: the TPU v5e's own gradients in that file are printed beside the card's.
DIFF_WITNESS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "diff_tpu_f32.json")
#: The JAX package's f64 gradients at the same point, on a CPU
#: (scripts/probe_diff_f64_cpu.py): the solve stops on its relative
#: tolerance short of stationarity, so the f64 "ift" gradient (exact at a
#: stationary point) lies ~5e-4 from the finite differences in either
#: package; the port's f64 "ift" is held to the JAX package's, its f64
#: "unrolled" to the finite differences.
DIFF_F64_WITNESS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "diff_f64_jax_cpu.json")
DIFF_X0 = (0.15, math.pi / 2 - 0.15, 0.1, -0.2)
#: probe_diff_tpu.py's gates: cosine with the witness, max relative error
#: in x (denominator max(|g_fd|, 1e-3)), relative error in m_1.
DIFF_COS, DIFF_REL = 0.999, 0.05
#: The f64 gates (tests/test_diff.py's) and the saturated stall's.
DIFF_F64_RTOL, DIFF_F64_ATOL, STALL_RTOL = 2e-4, 1e-7, 1e-3
#: tests/test_diff_saturation.py's stall: window 20, u_limit 31, 60
#: iterations, f64, from STALL_X0.
STALL_KWARGS = dict(max_iterations=60, window_length=20, state_spacing=5,
                    u_guess_sinusoid_amplitude=0.0, u_limit=31.0)
STALL_X0 = (0.1, math.pi / 2 + 0.15, -0.05, 0.1)
#: Adam steps of tools/sysid.py run by the smoke (the tool runs 120).
SYSID_SMOKE_STEPS = 2
#: Samples of each timed call (the median is printed; the unrolled
#: gradient, 8-15 s, has only the gate's); the gates' own gradients at the
#: probe point count among them.
DIFF_TIMING_REPS = 3


def diff_witness():
    with open(DIFF_WITNESS) as f:
        return json.load(f)


def diff_f64_witness():
    with open(DIFF_F64_WITNESS) as f:
        return json.load(f)


def diff_gate(g_x, g_m1, fd):
    """probe_diff_tpu.py's gates of a gradient ``(g_x (4,), g_m1)`` against
    the witness ``fd`` (``{"g_x", "g_m1"}``)."""
    g_x, g_fd = np.asarray(g_x, np.float64), np.asarray(fd["g_x"])
    cos = float(g_x @ g_fd / (np.linalg.norm(g_x) * np.linalg.norm(g_fd)))
    rel_x = float(np.max(np.abs(g_x - g_fd) / np.maximum(np.abs(g_fd), 1e-3)))
    rel_m = float(abs(g_m1 - fd["g_m1"]) / max(abs(fd["g_m1"]), 1e-3))
    ok = cos >= DIFF_COS and rel_x <= DIFF_REL and rel_m <= DIFF_REL
    return dict(cos=cos, max_rel_err_x=rel_x, rel_err_m1=rel_m, ok=bool(ok))


def close_gate(g, g_ref, rtol, atol=0.0):
    """``np.allclose(g, g_ref, rtol, atol)`` with the largest relative
    error (numpy arrays)."""
    g, g_ref = np.asarray(g, np.float64), np.asarray(g_ref, np.float64)
    rel = float(np.max(np.abs(g - g_ref) / np.abs(g_ref)))
    return dict(max_rel_err=rel, ok=bool(np.allclose(g, g_ref, rtol=rtol,
                                                     atol=atol)))


def run_diff(dev, card):
    """[diff]: the differentiable solve (``make_differentiable_solve``,
    both backward methods) and ``tools/sysid.py`` on the card; each phase
    is fatal on failure. No kernel of the repo lies on this path: the
    counts must stay 0. Every solve here is eager (~16-20 us of host time
    a launch, PERF.md), so each phase takes its numbers from as few solves
    as it can: the diagnostics ride on the gradient's solve, the saturated
    stall's central differences are one vmapped forward, and the timing
    reuses the gates' gradients as samples."""
    from cartpole_tpu_torch.tools import sysid

    t_group = time.perf_counter()
    f32, f64 = torch.float32, torch.float64

    def phase_done(tag):
        print(f"[diff] {time.perf_counter() - t_group:.1f} s after {tag}",
              flush=True)

    def counted(tag, fn):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if any(counts().values()):
            raise SystemExit(f"[{tag}] launched a kernel of the repo: "
                             f"{counts()}")
        return out, secs

    witness, w64 = diff_witness(), diff_f64_witness()
    fd = witness["fd_f64_cpu"]
    mpc = pt.make_mpc(pt.OptimizationParams(
        max_iterations=12, state_spacing=5, kkt_method="condensed"))
    u0 = mpc.spec.u_start

    def probe_args(dtype):
        return (torch.tensor(DIFF_X0, dtype=dtype, device=dev),
                pt.default_single_params(dtype, dev),
                mpc.init_state(dtype, dev))

    def probe_grad(dtype, method):
        """(dL/dx, dL/dm_1, the diagnostics) at the probe point: "ift"
        through ``torch.func.grad``, "unrolled" through ``.backward()``
        (its recomputed solve's graph is recorded once there, twice under
        an outer ``torch.func.grad``: half the host memory)."""
        x0, dp, st = probe_args(dtype)
        solve = pt.make_differentiable_solve(mpc, with_diagnostics=True,
                                             method=method)

        def loss(x, d):
            z, diag = solve(x, d, 0.0, st)
            return torch.sum(z[u0:] ** 2), diag

        if method == "ift":
            (gx, gd), diag = torch.func.grad(loss, argnums=(0, 1),
                                             has_aux=True)(x0, dp)
            return gx.double().cpu().numpy(), float(gd.m_1), diag
        x0.requires_grad_()
        m1 = dp.m_1.clone().requires_grad_()
        value, diag = loss(x0, dataclasses.replace(dp, m_1=m1))
        value.backward()
        return x0.grad.double().cpu().numpy(), float(m1.grad), diag

    samples = {"gradient ift": [], "gradient unrolled": []}

    # ----------------------------------------------------- on-chip gradient
    f32_grads = {}
    for method in ("ift", "unrolled"):
        (gx, gm, diag), secs = counted("diff", lambda: probe_grad(f32,
                                                                 method))
        samples[f"gradient {method}"].append(secs * 1e3)
        f32_grads[method] = (gx, gm)
        g = diff_gate(gx, gm, fd)
        tpu = witness[method]
        print(f"[diff] {method}, f32, at the point of scripts/"
              f"probe_diff_tpu.py (window 40, spacing 5, condensed, 12 "
              f"iterations, x0 {list(DIFF_X0)}, L = sum(u*^2)): n_active "
              f"{int(diag['n_active'])}, termination_state "
              f"{int(diag['termination_state'])}; dL/dx {gx.tolist()}, "
              f"dL/dm_1 {gm!r}; against diff_tpu_f32.json's fd_f64_cpu: "
              f"{json.dumps(g)} (gates cos >= {DIFF_COS}, relative errors "
              f"<= {DIFF_REL}); {secs:.2f} s  ({card}). The TPU v5 lite's, "
              f"from that file: diagnostics "
              f"{json.dumps(witness['diagnostics'])}, dL/dx {tpu['g_x']}, "
              f"dL/dm_1 {tpu['g_m1']}, cos {tpu['cos_vs_fd']}, "
              f"max_rel_err_x {tpu['max_rel_err_x']}, rel_err_m1 "
              f"{tpu['rel_err_m1']}", flush=True)
        if not g["ok"]:
            raise SystemExit(f"[diff] the f32 {method} gradient departs "
                             f"from the finite differences")
    phase_done("the f32 gradients")

    # ------------------------------------------------------------------ f64
    (gx, gm, _), secs = counted("diff", lambda: probe_grad(f64, "ift"))
    ref = w64["ift"]
    g = close_gate(np.r_[gx, gm], np.r_[ref["g_x"], ref["g_m1"]],
                   DIFF_F64_RTOL, DIFF_F64_ATOL)
    to_fd = close_gate(np.r_[gx, gm], np.r_[fd["g_x"], fd["g_m1"]],
                       DIFF_F64_RTOL, DIFF_F64_ATOL)["max_rel_err"]
    print(f"[diff] ift, f64: dL/dx {gx.tolist()}, dL/dm_1 {gm!r}; against "
          f"the JAX package's f64 ift (diff_f64_jax_cpu.json): "
          f"{json.dumps(g)} (gate rtol {DIFF_F64_RTOL:g}, atol "
          f"{DIFF_F64_ATOL:g}); max relative error against the finite "
          f"differences {to_fd:.3e} (the JAX package's "
          f"{ref['max_rel_err_x_vs_fd']:.3e} in x, "
          f"{ref['rel_err_m1_vs_fd']:.3e} in m_1: the solve stops short of "
          f"stationarity); {secs:.2f} s  ({card})", flush=True)
    if not g["ok"]:
        raise SystemExit("[diff] the f64 ift gradient departs from the JAX "
                         "package's")
    phase_done("f64")

    # ------------------------------------------------------------ precision
    torch.set_float32_matmul_precision("high")
    try:
        (gx, gm, _), secs = counted("diff", lambda: probe_grad(f32, "ift"))
    finally:
        torch.set_float32_matmul_precision("highest")
    samples["gradient ift"].append(secs * 1e3)
    g = diff_gate(gx, gm, fd)
    same = bool(np.array_equal(gx, f32_grads["ift"][0])
                and gm == f32_grads["ift"][1])
    print(f"[diff] ift, f32, under torch.set_float32_matmul_precision("
          f"\"high\"): {json.dumps(g)}; the bits of the default setting's "
          f"gradient: {same}; {secs:.2f} s  ({card})", flush=True)
    if not g["ok"]:
        raise SystemExit("[diff] the ift gradient departs from the finite "
                         "differences under the \"high\" matmul precision")
    phase_done("precision")

    # ----------------------------------------------------------- saturation
    mpc_s = pt.make_mpc(pt.OptimizationParams(**STALL_KWARGS))
    us = mpc_s.spec.u_start
    xs0 = torch.tensor(STALL_X0, dtype=f64, device=dev)
    dp64 = pt.default_single_params(f64, dev)
    st_s = mpc_s.init_state(f64, dev)
    unrolled = pt.make_differentiable_solve(mpc_s, with_diagnostics=True,
                                            method="unrolled")
    ift = pt.make_differentiable_solve(mpc_s)
    eps = 1e-6
    steps = eps * torch.eye(4, dtype=f64, device=dev)

    def stall_loss(x):
        z, diag = unrolled(x, dp64, 0.0, st_s)
        return torch.sum(z[us:] ** 2), diag

    def stall_grad():
        x = xs0.clone().requires_grad_()
        value, diag = stall_loss(x)
        value.backward()
        return x.grad, diag

    (g_un, diag), secs_un = counted("diff", stall_grad)
    # The central differences' 8 solves in one vmap of the forward.
    vals, secs_fd = counted("diff", lambda: torch.func.vmap(
        lambda x: stall_loss(x)[0])(torch.cat([xs0 + steps, xs0 - steps])))
    g_ift, secs_ift = counted("diff", lambda: torch.func.grad(
        lambda x: torch.sum(ift(x, dp64, 0.0, st_s)[us:] ** 2))(xs0))
    g_un, g_ift = g_un.cpu().numpy(), g_ift.cpu().numpy()
    n_act, term = diag["n_active"], diag["termination_state"]
    fd_s = ((vals[:4] - vals[4:]) / (2 * eps)).cpu().numpy()
    g = close_gate(g_un, fd_s, STALL_RTOL)
    finite = bool(np.isfinite(g_ift).all() and np.isfinite(g_un).all())
    n_act = int(n_act)
    print(f"[diff] saturated stall (tests/test_diff_saturation.py: window "
          f"20, u_limit 31, 60 iterations, f64): n_active {n_act}, "
          f"termination_state {int(term)}; unrolled dL/dx {g_un.tolist()} "
          f"against central differences on the card {fd_s.tolist()}: "
          f"{json.dumps(g)} (gate rtol {STALL_RTOL:g}); {secs_un:.2f} s for "
          f"the gradient (.backward()), {secs_fd:.2f} s for the 8 "
          f"neighbours' solves in one vmap; ift dL/dx {g_ift.tolist()}, "
          f"finite {finite}, {secs_ift:.2f} s  ({card})", flush=True)
    if n_act < 2 or not g["ok"] or not finite:
        raise SystemExit("[diff] the saturated stall's gates failed")
    phase_done("saturation")

    # ----------------------------------------------------------------- vmap
    mpc_id = sysid.make_mpc_for()
    xs = torch.as_tensor(sysid.excitation_states(), dtype=f64, device=dev)
    solve_id = pt.make_differentiable_solve(mpc_id)
    st_id = mpc_id.init_state(f64, dev)
    ui = mpc_id.spec.u_start

    def plan_loss(x):
        return torch.sum(solve_id(x, dp64, 0.0, st_id)[ui:] ** 2)

    gs, vmap_s = counted("diff", lambda: torch.func.vmap(
        torch.func.grad(plan_loss))(xs))
    rows = [torch.func.grad(plan_loss)(xs[i]) for i in range(len(xs))]
    rel = float(max((torch.abs(gs[i] - r) / torch.abs(r)).max()
                    for i, r in enumerate(rows)))
    finite = bool(torch.isfinite(gs).all())
    ok = finite and all(torch.allclose(gs[i], r, rtol=1e-9, atol=0)
                        for i, r in enumerate(rows))
    print(f"[diff] torch.func.vmap(torch.func.grad(loss)) over the "
          f"{len(xs)} states of tools/sysid.py (window 20, 20 iterations, "
          f"f64, L = sum(u*^2)): {vmap_s:.2f} s; each row against the "
          f"unbatched gradient: max relative error {rel:.3e} (gate 1e-9), "
          f"finite {finite}  ({card})", flush=True)
    if not ok:
        raise SystemExit("[diff] the vmapped gradients depart from the "
                         "unbatched ones")
    phase_done("vmap")

    # ---------------------------------------------------------------- sysid
    base = pt.default_single_params(f64, dev)
    plans = sysid.make_plans(mpc_id, xs)

    def sysid_run():
        with torch.no_grad():
            u_data = plans(sysid.with_fit(base, torch.tensor(
                sysid.TRUE_VALUES, dtype=f64, device=dev)))
        loss = sysid.make_loss(plans, base, u_data)
        return sysid.fit(loss, torch.tensor(sysid.INITIAL_VALUES, dtype=f64,
                                            device=dev), SYSID_SMOKE_STEPS)

    (v, losses), secs = counted("sysid", sysid_run)
    ok = bool(np.isfinite(losses).all() and losses[-1] < losses[0]
              and torch.isfinite(v).all())
    print(f"[sysid] tools/sysid.py, its first {SYSID_SMOKE_STEPS} Adam "
          f"steps (8 states, window 20, f64): losses {losses}, m_1, l_1 "
          f"{v.cpu().tolist()} (true {list(sysid.TRUE_VALUES)}); {secs:.2f} "
          f"s with the data's solve  ({card})", flush=True)
    if not ok:
        raise SystemExit("[sysid] the loss is not finite or did not fall")
    phase_done("sysid")

    # --------------------------------------------------------------- timing
    x0, dp32, st32 = probe_args(f32)
    forward = pt.make_differentiable_solve(mpc)

    def fwd():
        with torch.no_grad():
            forward(x0, dp32, 0.0, st32)

    samples["forward"] = tick_ms(fwd, DIFF_TIMING_REPS)
    for method, n in (("ift", DIFF_TIMING_REPS), ("unrolled", 1)):
        key = f"gradient {method}"
        samples[key] += tick_ms(lambda: probe_grad(f32, method),
                                n - len(samples[key]))
    prof = profile_calls(lambda: probe_grad(f32, "ift"))
    med = {k: float(np.median(v)) for k, v in samples.items()}
    for k in ("forward", "gradient ift", "gradient unrolled"):
        back = (f"; backward {med[k] - med['forward']:.1f} ms (the gradient "
                f"less the forward's median)" if k != "forward" else "")
        print(f"[timing] diff, {k}, single f32 at the probe point: median "
              f"{med[k]:.1f} ms of {[round(t, 1) for t in samples[k]]}"
              f"{back}  ({card})", flush=True)
    print(f"[timing] diff, one ift gradient under torch.profiler: "
          f"{json.dumps(prof)}; the vmap gradient over {len(xs)} states, "
          f"f64: {vmap_s * 1e3:.1f} ms  ({card})", flush=True)
    print(f"[diff] {time.perf_counter() - t_group:.1f} s for the group  "
          f"({card})", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    return run(torch.device("cuda", 0))


def run(dev) -> int:
    """Every phase on ``dev``; raises ``SystemExit`` on the first failed
    gate. A batching rule that ``torch.func.vmap`` lacks would run a batch
    as a loop over its instances: its warning is an error here."""
    warnings.filterwarnings("error", message="There is a performance drop")
    # ---------------------------------------------------------------- device
    card = _card()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t_start = time.perf_counter()

    def elapsed(phases):
        print(f"[elapsed] {time.perf_counter() - t_start:.1f} s after "
              f"{phases}", flush=True)

    # ----------------------------------------------------------------- build
    t0 = time.perf_counter()
    path, log = _build.build_library()
    _build.load_library()
    build_s = time.perf_counter() - t0
    print(f"[build] {build_s:.1f} s -> {os.path.relpath(path)}; seconds "
          f"per source: {' '.join(re.findall(r'^== (.*)$', log, re.M))}",
          flush=True)
    if not log:
        print("[build] the library was built before: no ptxas report",
              flush=True)
    if log:
        build_report(ptxas_entries(log))

    B = BATCH
    mpc = pt.make_mpc(pt.OptimizationParams(
        max_iterations=8, state_spacing=5, kkt_method="condensed"))
    cfg = mpc.nls_config
    h, angle = mpc.params.control_dt, mpc.model.angle_indices
    dp = pt.default_single_params(torch.float32, dev)
    x0 = torch.as_tensor(make_x0s("single", B), dtype=torch.float32,
                         device=dev)
    cold = cold_state(mpc, B, dev)

    # ---------------------------------------- kernel 2 vs its plain version
    S, sp = mpc.spec.num_states - 1, mpc.spec.spacing
    R = S * B
    check_segment_jac("random columns, seed 0",
                      segment_inputs_random(R, sp, dev), h, card)
    check_segment_jac("random columns, ragged", segment_inputs_random(
        RAGGED_COLUMNS, sp, dev, seed=1), h, card)
    for n_steps in (1, pk.SPMAX):
        check_segment_jac(f"random columns, sp={n_steps}",
                          segment_inputs_random(R, n_steps, dev, seed=2), h,
                          card)
    problem_c, Z0_c = setup_problem(mpc, cold, x0, torch.float64)
    seg_cold = segment_inputs_problem(problem_c, Z0_c)
    seg_err = check_segment_jac("cold-start shooting problem", seg_cold, h,
                                card)
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

    elapsed("the single's kernel checks")

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
    r_end = compare(mpc, res.final_mpc_state, res.final_state, nudge="u")
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

    elapsed("path 1 and the disturbed run")

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
        h, card))

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

    elapsed("path 2 and cross")

    # ------------------------------------------ the double and triple poles
    checks_d = check_multilink_kernels(pt.DOUBLE_CARTPOLE, dev, card)
    run_d = run_double(dev, card, checks_d["floor"])
    elapsed("the double's phases")
    checks_t = check_multilink_kernels(pt.TRIPLE_CARTPOLE, dev, card)
    run_t = run_triple(dev, card)
    elapsed("the triple's phases")
    run_per_instance(dev, card)
    elapsed("the per-instance group")
    run_diff(dev, card)
    elapsed("the diff group")
    multilink = {pt.DOUBLE_CARTPOLE: (checks_d, run_d),
                 pt.TRIPLE_CARTPOLE: (checks_t, run_t)}

    # --------------------------------------------------------------- timings
    def median_tick(fused_flag, x, mst, n=MEDIAN_TICKS):
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
          f"{med_tick:.2f} ({MEDIAN_TICKS} single ticks); kernel 1 "
          f"{kern_ms:.3f} "
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
          f"{loop2_s / TICKS_PATH2 * 1e3:.2f}, median {med_tick2:.2f} "
          f"({MEDIAN_TICKS} "
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

    elapsed("the single's timing")
    extra = []
    for model, (checks, drove) in multilink.items():
        extra += time_multilink(model, drove, checks, card)
        elapsed(f"the {model.name}'s timing")
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
    ] + extra}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
