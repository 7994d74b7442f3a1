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
``run_scheduled_closed_loop`` with the bench's whole 250-tick schedule
and its transient weight (``DOUBLE_SCHEDULE``), the triple through
``run_closed_loop_lanes``. On the card every such closed loop runs its
first tick eagerly, captures its tick in a CUDA graph and replays it for
the rest (``mpc/lanes.py``), as the JAX package compiles its loop into one
scan.

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
(100 ticks of path 1 with a shove at the pole mass); path 2; bitwise (the
first ``BITWISE_TICKS`` ticks of path 1, of path 2 and of a short run with
the shove's force, each against the tick function run eagerly from the
same inputs: identical bits); kernel 2
against its plain version on the warm linearization after path 2's last
tick; cross (path 2 against path 1 on the cold-start problem, and path 2
under ``torch.set_float32_matmul_precision("high")``); for the double and
the triple, segment_jac and kernel 1 against their plain versions at the
regime's width, then double (path 1 through the whole schedule in chunks,
its upright share at ``UPRIGHT_CHECKPOINTS`` against the JAX package's,
the card's memory flat over the chunks, path 2, the bitwise gate on both
paths, and cross on the cold problem) and triple (path 1 and path 2);
timing (both
kernels by device time, ``device_ms``: kernel 1 on the warm problem after
path 1's last tick, kernel 2 on the cold and the warm problem, for every
model), a profile of one eager tick of each single-model path
(device-busy share, kernel launches), each path's tick and the double's
and triple's path-1 tick as CUDA-graph replays (the capture's and
instantiation's seconds and the graph pool's bytes from the ``graph.*``
spans, a replay's median ms beside an eager tick's, its device ms by
phase, one replay profiled), with
both kernels' launch layouts (registers, shared bytes per block, resident
blocks and warps per SM). The per-instance group (``MPC.step``,
``run_closed_loop``, ``vmap``; no kernel of the repo lies on it) runs as
a process of its own (``--group per-instance``) from the end of the build,
beside the single's paths, and its output is printed after the triple's
phases: oracle
(the ``lu`` closed loop, f64, against the C++ oracle on the host), swing-up
(``tools/swingup.py`` at its defaults: the reference's 250-tick test, with
its gates), schur, vmap (tick 1 of
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
``vmap(grad)`` over the sysid states; diff-graph: each of these gradients
(both methods in f32, ``ift`` in f64, the vmap) made ``diff.graphed`` (one
CUDA-graph capture, replayed), the replay against the eager run on the
same inputs bit for bit; sysid: the tool's first steps eagerly, then all
its 120 steps through one capture (``m_1`` and ``l_1`` within 5e-3, the
first losses the eager fit's bits); and their timing, eager and replayed;
it runs as a process of its own (``--group diff``) from the end of the
build, beside the single's, double's and triple's paths, and its output
is printed after them. Then
the cli group, the entry points as a user starts them
(``python -m cartpole_tpu_torch``): ``sweep`` at batch 4096 in f32 with
``--layout lanes-fused`` (kernel 1) and ``lanes`` (kernel 2),
``tools/batch_sweep.py --fused`` (a grid of per-scenario pole masses and
lengths; kernel 1) and at its defaults (``vmap``, batch 512), the same
lanes-fused sweep on two ranks of the one card under ``torchrun`` (gloo)
against one rank, ``closed-loop`` in f64 with ``--log-json`` and its
``replay``, ``solve`` as a process of its own, and the sweep's
``trace_scope`` span. The interactive demo's groups run as a process of
their own (``--group interactive``) from the start, beside the build and
the single's, double's and triple's paths, and launch no
kernel of the repo: interactive (``python -m cartpole_tpu_torch
interactive`` without a tty, a process of its own, against the JAX
package's run of it, ``interactive_jax_cpu.json``; an ``InteractiveLoop``
through a poke, a dynamics slider, a set point, the ``t`` rebuild, the
controller off and on and a reset, each replayed tick held to the eager
tick on the same inputs bit for bit; a replayed tick's and a rebuild's
time, and the card's memory over rebuilds and ``run_closed_loop`` calls),
web (a ``WebApp`` on the card:
every route, the 400s of malformed bodies, and its realtime tick thread's
simulated seconds per wall second) and triple-swingup
(tests/test_triple.py::TestTrackedSwingUp: the plan of
``triple_swingup_traj.npz`` replayed open loop, a plant step captured in a
CUDA graph, then ``run_closed_loop``'s 150-tick catch, its gates, and
both states beside the JAX package's, ``triple_tracked_jax_cpu.json``).
The kernels line counts the launches of path 1 and path 2 and of the
cli group's sweeps.
Every kernel launch counter is set to 0 just before a path is driven and
read just after. Prints the card's name and power limit beside every
number, one JSON line describing the kernels, and as its last line
``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py   (``--group diff``: only the diff group;
``--group diff-profile``: only its profiled eager and replayed gradient;
``--group interactive``: only the interactive, web and triple-swingup
groups; ``--group per-instance``: only the per-instance group, with the
kernels built)
Needs one CUDA device, nvcc (CUDA toolkit) and the repository beside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import signal
import socket
import subprocess
import sys
import time
import warnings
from unittest import mock

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.profiler import ProfilerActivity, profile

import cartpole_tpu_torch as pt
from cartpole_tpu_torch.mpc import closed_loop as cl
from cartpole_tpu_torch.mpc import lanes
from cartpole_tpu_torch.ops import _build, fused
from cartpole_tpu_torch.ops import pallas_kernels as pk
from cartpole_tpu_torch import cli
from cartpole_tpu_torch import utils as ptu
from cartpole_tpu_torch.utils.roofline import bound, count_ops

BATCH, TICKS, TICKS_PATH2, TICKS_DISTURBED = 4096, 250, 150, 100
#: Single-tick calls (eager ticks) whose median is the single's eager
#: ms/tick; one for the double's and triple's.
MEDIAN_TICKS = 3
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
#: bench.py's double-pole outcome run (``_double_health``), whole: 250
#: ticks, an 8x u-rate weight for the first 50 cold-start ticks, then the
#: base weights. It runs in chunks of DOUBLE_CHUNK ticks (40 + 10, then 5 x
#: 40), so each phase crosses a chunk boundary and the warm start is
#: carried across chunks and across the switch; each chunk is one call,
#: which replays one CUDA-graph capture of its tick from its second tick.
DOUBLE_SCHEDULE = ((50, {"u_derivative_cost_weight": 0.8}), (200, None))
DOUBLE_CHUNK = 40
#: The JAX bench's outcome of the 250-tick run (BENCH_r05.json, TPU v5e),
#: printed beside this run's, and the gate on failed solves: the count of
#: the JAX package's unscheduled 250-tick run (knockdowns.json
#: ``n_failed_base``).
DOUBLE_REFERENCE = dict(fraction_upright=0.9956, n_failed=0)
DOUBLE_MAX_FAILED = 4
#: The upright share of the same schedule tick by tick, from the JAX
#: package's lanes loop on a CPU in f32 over the first 512 states of
#: make_x0s("double", 4096) (scripts/probe_double_upright_cpu.py, 250
#: ticks): the port's share at each of UPRIGHT_CHECKPOINTS must lie within
#: UPRIGHT_SIGMAS binomial standard deviations of it.
UPRIGHT_WITNESS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "double_upright_jax_cpu.json")
UPRIGHT_CHECKPOINTS, UPRIGHT_SIGMAS = (50, 100, 150, 200, 250), 4.0
#: The double's path 2 and the triple's paths run 10, 30 and 10 ticks
#: (PERF.md §4).
TICKS_DOUBLE_PATH2, TICKS_TRIPLE, TICKS_TRIPLE_PATH2 = 10, 30, 10
#: Ticks of the tick function run eagerly that a closed loop's first ticks
#: (its replays from the third) must equal bit for bit.
BITWISE_TICKS = 5
#: Replays whose median is a replayed tick's ms.
REPLAY_TICKS = 10


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


def upright_witness(path=UPRIGHT_WITNESS, schedule=DOUBLE_SCHEDULE):
    """The JAX package's upright share of the double's regime, tick by
    tick (``UPRIGHT_WITNESS``); it must have run ``schedule``."""
    with open(path) as f:
        w = json.load(f)
    if w["schedule"] != [list(phase) for phase in schedule]:
        raise SystemExit(f"[double] {path} ran another schedule: "
                         f"{w['schedule']}")
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


# ----------------------------------------------------- the graphed loop
def zero_set_point(x):
    """The set point ``run_closed_loop_lanes`` makes of its default 0.0."""
    return torch.broadcast_to(torch.as_tensor(0.0, dtype=x.dtype,
                                              device=x.device), (x.shape[0],))


def eager_ticks(mpc, x0, dp, n, fused_flag, mpc_state=None,
                disturbances=None):
    """``n`` ticks of ``mpc/lanes.py::tick_fn_lanes`` run eagerly from
    ``x0`` (B, sd) and ``mpc_state`` (cold if None), with the slices of
    ``disturbances`` (B, n, 2, 2) that ``run_closed_loop_lanes`` copies
    into its graph. Returns the batch-first fields of ``BITWISE_FIELDS``."""
    if mpc_state is None:
        mpc_state = cold_state(mpc, x0.shape[0], x0.device)
    tick = lanes.tick_fn_lanes(mpc, dp, zero_set_point(x0), True,
                               fused_flag)
    carry = (x0.T, mpc_state.previous_solution, mpc_state.warm)
    rows = []
    for t in range(n):
        dist = (() if disturbances is None
                else (disturbances[:, t].permute(1, 2, 0),))
        out = tick(*carry, *dist)
        rows.append(out[3:])
        carry = out[:3]
    cols = [torch.stack(c, dim=1) for c in zip(*rows)]
    return dict(states=cols[0], controls=cols[1],
                termination_states=cols[3], solver_iterations=cols[5])


#: What the bit-for-bit gate compares.
BITWISE_FIELDS = ("states", "controls", "termination_states",
                  "solver_iterations")


def _bits(t):
    """``t`` as integers of its width, so that NaNs compare by their bits."""
    if t.is_floating_point():
        return t.contiguous().view(
            {8: torch.int64, 4: torch.int32, 2: torch.int16}[
                t.element_size()])
    return t


def bits_differ(eager, res):
    """The fields of ``BITWISE_FIELDS`` whose first ticks in ``res`` (a
    closed loop's result) are not the bits of ``eager`` (``eager_ticks``)."""
    n = eager["states"].shape[1]
    return [k for k in BITWISE_FIELDS if not torch.equal(
        _bits(eager[k]), _bits(getattr(res, k)[:, :n]))]


def check_bitwise(tag, eager, res, card):
    """[bitwise]: a closed loop's first ticks (tick 0 eager, tick 1 its
    capture's warm-up, the rest replays) against ``eager`` bit for bit."""
    n = eager["states"].shape[1]
    bad = bits_differ(eager, res)
    print(f"[bitwise] {tag}: the first {n} ticks of the closed loop (tick 0 "
          f"eager, tick 1 the capture's warm-up, ticks 2-{n - 1} replays) "
          f"against {n} ticks of the tick function run eagerly: "
          + (f"different bits in {bad}" if bad else
             f"identical bits in {', '.join(BITWISE_FIELDS)}")
          + f"  ({card})", flush=True)
    if bad:
        raise SystemExit(f"[bitwise] {tag}: the replayed loop departs from "
                         f"the eager ticks in {bad}")


def allocator_blocks():
    """The caching allocator's allocated blocks on the current device:
    address -> bytes. A block can be up to ~1 MB larger than the tensor
    in it (the allocator does not split a free block for a smaller
    remainder), and ``memory_allocated`` counts the block."""
    dev = torch.cuda.current_device()
    blocks = {}
    for seg in torch.cuda.memory_snapshot():
        if seg.get("device", dev) != dev:
            continue
        addr = seg["address"]
        for b in seg["blocks"]:
            if b["state"] == "active_allocated":
                blocks[addr] = b["size"]
            addr += b["size"]
    return blocks


def held_bytes(results, blocks=None):
    """Bytes of the distinct storages that closed-loop results hold: the
    allocator's block of each (``blocks``, from ``allocator_blocks``), or
    the storage's own size where it has none."""
    storages = {}
    for res in results:
        for t in pytree.tree_leaves(res):
            st = t.untyped_storage()
            storages[st.data_ptr()] = (blocks or {}).get(st.data_ptr(),
                                                         st.nbytes())
    return sum(storages.values())


def memory_flat(values, ref):
    """The memory gate over a chunked closed loop: ``values`` are
    ``memory_allocated`` less the results held after each chunk; the last
    may not be above the one after chunk ``ref``."""
    return values[-1] <= values[ref]


def time_graphed(tag, mpc, dp, res, fused_flag, eager_ms, card):
    """[timing] of a replayed lanes tick: ``CUDAGraphTick`` over
    ``tick_fn_lanes`` at the warm state after ``res``'s last tick, built
    with tracing on: its capture's and its instantiation's seconds and its
    private pool's bytes (:func:`graph_stats`), the median ms of
    ``REPLAY_TICKS`` replays (inputs in, replay, outputs cloned) beside
    ``eager_ms`` (an eager tick's), the last replay's device ms by phase
    (``phase_ms``), and one replay under the profiler. The graph goes when
    this returns."""
    x, mst = res.final_state, res.final_mpc_state
    tick = lanes.tick_fn_lanes(mpc, dp, zero_set_point(x), True, fused_flag)
    args = (x.T, mst.previous_solution, mst.warm)
    torch.cuda.synchronize()
    ptu.set_tracing_enabled(True)
    try:
        graph = cl.CUDAGraphTick(tick, args)
    finally:
        ptu.set_tracing_enabled(False)
    out = dict(graph_stats(),
               replay_ms=float(np.median(tick_ms(lambda: graph(*args),
                                                 REPLAY_TICKS))),
               phase_ms=graph.phase_ms(), eager_ms=eager_ms,
               replay_profile=profile_calls(lambda: graph(*args)))
    print(f"[timing] {tag}, the lanes tick as a CUDA-graph replay (warm "
          f"state after the run's last tick): {json.dumps(out)}  ({card})",
          flush=True)
    return out


def run_double(dev, card, floor):
    """[double]: bench.py's double-pole outcome run on path 1 through
    ``run_scheduled_closed_loop`` (``DOUBLE_SCHEDULE``, whole, in chunks
    of ``DOUBLE_CHUNK``), with its upright share tick by tick against the
    JAX package's and the card's memory after each chunk (flat from the
    second chunk of the base phase, when every controller of the schedule
    exists, to the last); the first ``TICKS_DOUBLE_PATH2`` ticks of the
    same schedule on path 2; both runs' first ticks against the eager tick
    function bit for bit; and [cross] path 2 against path 1 on the cold
    problem, against ``floor``: the plain version's agreement with itself
    on that problem after a one-ulp nudge (``check_multilink_kernels``)."""
    model = pt.DOUBLE_CARTPOLE
    mpc = multilink_mpc(model)
    B = BATCH
    dp = model.params_type().to(torch.float32, dev)
    x0 = torch.as_tensor(make_x0s("double", B), dtype=torch.float32,
                         device=dev)
    ticks = sum(n for n, _ in DOUBLE_SCHEDULE)
    parts, mems = [], []

    def on_chunk(part):
        parts.append(part)
        torch.cuda.synchronize()
        mems.append(torch.cuda.memory_allocated()
                    - held_bytes(parts, allocator_blocks()))

    res, secs, n1, failed, up = run_loop(
        "double", model, mpc, lambda: pt.run_scheduled_closed_loop(
            mpc, x0, dp, DOUBLE_SCHEDULE, layout="lanes", fused=True,
            max_ticks_per_program=DOUBLE_CHUNK, on_chunk=on_chunk),
        ticks, True, card)
    print(f"[double] schedule {json.dumps(DOUBLE_SCHEDULE)} in chunks of "
          f"{DOUBLE_CHUNK} ticks: "
          f"fraction_upright {up:.4f}, n_failed {failed} (gate <= "
          f"{DOUBLE_MAX_FAILED}); the JAX bench's 250-tick run of this "
          f"regime: {json.dumps(DOUBLE_REFERENCE)} (TPU v5e, "
          f"BENCH_r05.json); outcomes, not times  ({card})", flush=True)
    ref = -(-DOUBLE_SCHEDULE[0][0] // DOUBLE_CHUNK) + 1
    flat = memory_flat(mems, ref)
    print(f"[double] memory_allocated less the results held, after each "
          f"of the {len(mems)} chunks: {mems} B; the last not above chunk "
          f"{ref + 1}'s: {flat}  ({card})", flush=True)
    faults = [] if flat else ["the card's memory grew over the chunks"]
    if failed > DOUBLE_MAX_FAILED:
        faults.append("n_failed out of bounds")
    try:
        check_upright_curve(res, model, card)
    except SystemExit as e:
        faults.append(str(e))
    if faults:
        raise SystemExit(f"[double] {'; '.join(faults)}")
    transient = pt.make_mpc(dataclasses.replace(
        mpc.params, **DOUBLE_SCHEDULE[0][1]), model)
    check_bitwise("double, path 1", eager_ticks(
        transient, x0, dp, BITWISE_TICKS, True), res, card)
    first = ((TICKS_DOUBLE_PATH2, DOUBLE_SCHEDULE[0][1]),)
    res2, secs2, n2, _, _ = run_loop(
        "double", model, mpc, lambda: pt.run_scheduled_closed_loop(
            mpc, x0, dp, first, layout="lanes", fused=False),
        TICKS_DOUBLE_PATH2, False, card)
    check_bitwise("double, path 2", eager_ticks(
        transient, x0, dp, BITWISE_TICKS, False), res2, card)

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


def time_multilink(model, run, checks, card, median_ticks=1):
    """[timing] of one model: kernel 1 per solve on the warm problem after
    path 1's last tick and kernel 2 per launch on the cold problem (device
    time), their bounds on this run's data, their plain versions, the
    launch layouts, launches per tick, the median eager path-1 tick and
    the same tick replayed (``time_graphed``, which also profiles the
    replay: its device operations are the eager tick's launches). Returns
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
    time_graphed(f"{model.name}, path 1", mpc, dp, res, True, med_tick, card)

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
          f"tick  ({card})", flush=True)
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
    """The CLI's ``sweep`` states for the single model: hanging, b_x and
    theta moved by uniform draws in [-0.3, 0.3]."""
    return cli.sweep_x0s(pt.SINGLE_CARTPOLE, DOWN, n, seed)


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
    from cartpole_tpu_torch.tools import swingup

    t_group = time.perf_counter()

    def phase_done(tag):
        print(f"[per-instance] {time.perf_counter() - t_group:.1f} s after "
              f"{tag}", flush=True)

    f64 = torch.float64
    x_down = torch.tensor(DOWN, dtype=f64, device=dev)
    dp64 = pt.default_single_params(f64, dev)

    def drive(tag, mpc, x, dp, ticks, run=None):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = (run or (lambda: pt.run_closed_loop(mpc, x, dp, ticks)))()
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
        # The swing-up is tools/swingup.py at its defaults, which run this
        # configuration.
        tool = (lambda: swingup.main(["--out-dir", os.path.join(
            ROOT, "chiprun_out", "swingup")])[0]) if tag == "swing-up" \
            else None
        res, secs = drive(tag, mpc, x_down, dp64, ticks, tool)
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
              f"the hanging pole{' (tools/swingup.py)' if tool else ''}: "
              f"{secs:.2f} s, termination codes "
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
#: Adam steps of tools/sysid.py run eagerly by the smoke, whose losses
#: the graphed fit's first steps must equal bit for bit; the graphed fit
#: runs the tool's whole 120.
SYSID_SMOKE_STEPS = 2
#: Replays timed of each graph of the differentiable solve.
DIFF_GRAPH_REPS = 10
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


def same_bits(a, b):
    """Whether two tuples of tensors hold identical bits."""
    return len(a) == len(b) and all(
        x.shape == y.shape and torch.equal(_bits(x), _bits(y))
        for x, y in zip(a, b))


def graph_stats():
    """The newest ``CUDAGraphTick``'s capture and instantiation seconds and
    its pool's bytes: its ``graph.capture`` and ``graph.instantiate``
    spans, so it has to be built with tracing on."""
    events = json.loads(ptu.TraceCollector.get_instance()
                        .get_trace_json())["traceEvents"]
    last = {e["name"]: e for e in events}
    capture, inst = last["graph.capture"], last["graph.instantiate"]
    return dict(capture_s=capture["dur"] / 1e6,
                instantiate_s=inst["dur"] / 1e6,
                pool_bytes=capture["args"]["pool_bytes"])


def diff_probe_mpc():
    """scripts/probe_diff_tpu.py's controller (the probe point's)."""
    return pt.make_mpc(pt.OptimizationParams(
        max_iterations=12, state_spacing=5, kkt_method="condensed"))


def probe_grad_fn(mpc, dtype, dev, method):
    """``((x, m_1) -> (dL/dx, dL/dm_1), its arguments at the probe
    point)``, ``L = sum(u*^2)``: the gradient a user replays."""
    dp = pt.default_single_params(dtype, dev)
    st = mpc.init_state(dtype, dev)
    solve = pt.make_differentiable_solve(mpc, method=method)

    def loss(x, m1):
        z = solve(x, dataclasses.replace(dp, m_1=m1), 0.0, st)
        return torch.sum(z[mpc.spec.u_start:] ** 2)

    return (torch.func.grad(loss, argnums=(0, 1)),
            (torch.tensor(DIFF_X0, dtype=dtype, device=dev), dp.m_1.clone()))


def run_diff_profile(dev, card):
    """[timing] diff under torch.profiler, a process of its own that the
    [diff] group starts at its end: one eager f32 ``ift`` gradient at the
    probe point, then one replay of its CUDA graph. In the [diff] group's
    process, once its graphs had been made and freed, the profiler hung the
    next capture or crashed in a profiled replay (PERF.md §7); in a
    fresh process both run."""
    fn, args = probe_grad_fn(diff_probe_mpc(), torch.float32, dev, "ift")
    prof = profile_calls(lambda: fn(*args))
    print(f"[timing] diff, one ift gradient under torch.profiler: "
          f"{json.dumps(prof)}  ({card})", flush=True)
    g = pt.graphed(fn, args)
    g(*args)
    prof = profile_calls(lambda: g(*args))
    print(f"[timing] diff, one replayed ift f32 gradient (diff.graphed) "
          f"under torch.profiler: {json.dumps(prof)}  ({card})", flush=True)


def run_diff(dev, card):
    """[diff]: the differentiable solve (``make_differentiable_solve``,
    both backward methods) and ``tools/sysid.py`` on the card; each phase
    is fatal on failure. No kernel of the repo lies on this path: the
    counts must stay 0. The gates' solves are eager (~16-20 us of host
    time a launch, PERF.md), so each takes its numbers from as few solves
    as it can: the diagnostics ride on the gradient's solve, the saturated
    stall's central differences are one vmapped forward, and the timing
    reuses the gates' gradients as samples. [diff-graph] and [sysid] run
    the gradients as users run them on the card, replays of one
    CUDA-graph capture each (``diff.graphed``), and hold them to the eager
    ones."""
    from cartpole_tpu_torch.tools import sysid

    ptu.set_tracing_enabled(True)  # graph_stats reads each build's spans
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
    mpc = diff_probe_mpc()
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

    # ----------------------------------------------------------- diff-graph
    # Each gradient as users run it on the card (diff.graphed: one
    # CUDA-graph capture, replayed), against the eager run of the same
    # function on the same inputs, the capture's warm-up.
    def vmap_fn(xs_):
        return (torch.func.vmap(torch.func.grad(plan_loss))(xs_),)

    def forward_fn(dtype):
        """``x -> (z,)``, the probe point's solve without a gradient."""
        _, dp, st = probe_args(dtype)
        solve = pt.make_differentiable_solve(mpc)

        def fwd(x):
            with torch.no_grad():
                return (solve(x, dp, 0.0, st),)

        return fwd

    replayed = {}
    for tag, (fn, args) in (
            ("forward f32", (forward_fn(f32), probe_args(f32)[:1])),
            ("ift f32", probe_grad_fn(mpc, f32, dev, "ift")),
            ("unrolled f32", probe_grad_fn(mpc, f32, dev, "unrolled")),
            ("ift f64", probe_grad_fn(mpc, f64, dev, "ift")),
            ("vmap ift f64", (vmap_fn, (xs,)))):
        g, build_s = counted("diff-graph", lambda: pt.graphed(fn, args))
        out, replay_s = counted("diff-graph", lambda: g(*args))
        same = same_bits(out, g.warmup_outputs)
        also = ""
        if tag in ("ift f32", "unrolled f32"):
            gx, gm = f32_grads[tag.split()[0]]
            same_eager = bool(np.array_equal(out[0].cpu().numpy(), gx)
                              and float(out[1]) == gm)
            also = (f"; the [diff] phase's eager gradient's bits "
                    f"(.backward() for unrolled): {same_eager}")
        ms = tick_ms(lambda: g(*args), DIFF_GRAPH_REPS)
        replayed[tag] = dict(median_ms=float(np.median(ms)),
                             least_ms=min(ms), **graph_stats())
        print(f"[diff-graph] {tag}: the replay against the eager run on the "
              f"same inputs (the capture's warm-up): identical bits "
              f"{same}{also}; {json.dumps(graph_stats())}, {build_s:.2f} "
              f"s to build (warm-up, capture, instantiation), the first "
              f"replay {replay_s * 1e3:.1f} ms, then median "
              f"{replayed[tag]['median_ms']:.1f} ms of {DIFF_GRAPH_REPS}  "
              f"({card})", flush=True)
        if not same:
            raise SystemExit(f"[diff-graph] the replayed {tag} departs "
                             f"from the eager run")
        del g, out
    phase_done("diff-graph")

    # ---------------------------------------------------------------- sysid
    base = pt.default_single_params(f64, dev)
    plans = sysid.make_plans(mpc_id, xs)
    v0 = torch.tensor(sysid.INITIAL_VALUES, dtype=f64, device=dev)

    def sysid_loss():
        with torch.no_grad():
            u_data = plans(sysid.with_fit(base, torch.tensor(
                sysid.TRUE_VALUES, dtype=f64, device=dev)))
        return sysid.make_loss(plans, base, u_data)

    def eager_fit():
        # The tool's loop with its gradient run eagerly, as on the CPU.
        with mock.patch.object(sysid, "graphed", lambda fn, args: fn):
            return sysid.fit(sysid_loss(), v0, SYSID_SMOKE_STEPS)

    (v, losses_eager), secs = counted("sysid", eager_fit)
    ok = bool(np.isfinite(losses_eager).all()
              and losses_eager[-1] < losses_eager[0]
              and torch.isfinite(v).all())
    print(f"[sysid] tools/sysid.py, its first {SYSID_SMOKE_STEPS} Adam "
          f"steps eagerly (8 states, window 20, f64): losses "
          f"{losses_eager}, m_1, l_1 {v.cpu().tolist()} (true "
          f"{list(sysid.TRUE_VALUES)}); {secs:.2f} s with the data's solve  "
          f"({card})", flush=True)
    if not ok:
        raise SystemExit("[sysid] the loss is not finite or did not fall")

    made, stamps = [], []

    def graphed_spy(fn, args):
        made.append(pt.graphed(fn, args))
        return made[-1]

    def graphed_fit():
        loss = sysid_loss()
        with mock.patch.object(sysid, "graphed", graphed_spy):
            return sysid.fit(loss, v0, sysid.STEPS, log=lambda *_: (
                stamps.append(time.perf_counter())))

    (v, losses), secs = counted("sysid", graphed_fit)
    err = np.abs(v.cpu().numpy() - np.array(sysid.TRUE_VALUES))
    step_ms = np.diff(stamps) * 1e3
    first = losses[:SYSID_SMOKE_STEPS] == losses_eager
    ok = bool(len(made) == 1 and np.isfinite(losses).all()
              and losses[-1] < losses[0] and err.max() < sysid.TOLERANCE
              and first)
    print(f"[sysid] tools/sysid.py, all {sysid.STEPS} Adam steps through one "
          f"CUDA-graph capture of grad_and_value(loss) (8 states, window 20, "
          f"f64): {len(made)} capture(s), "
          f"{json.dumps(graph_stats())}; recovered m_1, l_1 "
          f"{v.cpu().tolist()}, abs err {err.tolist()} (gate < "
          f"{sysid.TOLERANCE:g}); loss {losses[0]!r} -> {losses[-1]!r}, "
          f"every step's finite {bool(np.isfinite(losses).all())}; the first "
          f"{SYSID_SMOKE_STEPS} losses the eager fit's bits: {first}; "
          f"{secs:.2f} s for the fit with the data's solve, the capture and "
          f"its warm-up; a step (replay, Adam) median "
          f"{float(np.median(step_ms)):.1f} ms of {len(step_ms)}, least "
          f"{float(step_ms.min()):.1f}  ({card})", flush=True)
    if not ok:
        raise SystemExit("[sysid] the graphed fit did not recover m_1 and "
                         "l_1, or departs from the eager fit")
    del made[:]
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
    med = {k: float(np.median(v)) for k, v in samples.items()}
    for k in ("forward", "gradient ift", "gradient unrolled"):
        back = (f"; backward {med[k] - med['forward']:.1f} ms (the gradient "
                f"less the forward's median)" if k != "forward" else "")
        print(f"[timing] diff, {k}, single f32 at the probe point: median "
              f"{med[k]:.1f} ms of {[round(t, 1) for t in samples[k]]}"
              f"{back}  ({card})", flush=True)
    print(f"[timing] diff, the vmap gradient over {len(xs)} states, f64: "
          f"{vmap_s * 1e3:.1f} ms  ({card})", flush=True)

    # The same calls replayed ([diff-graph]), beside the eager ones.
    eager = {"forward f32": med["forward"], "ift f32": med["gradient ift"],
             "unrolled f32": med["gradient unrolled"],
             "vmap ift f64": vmap_s * 1e3}
    for tag, r in replayed.items():
        beside = (f", eager {eager[tag]:.1f} ms (above)" if tag in eager
                  else "")
        print(f"[timing] diff, {tag} replayed (diff.graphed): median "
              f"{r['median_ms']:.1f} ms of {DIFF_GRAPH_REPS}, least "
              f"{r['least_ms']:.1f}{beside}; capture {r['capture_s']:.2f} "
              f"s, instantiation {r['instantiate_s']:.2f} s, pool "
              f"{r['pool_bytes']} B  ({card})", flush=True)
    # Under the profiler: a process of its own (run_diff_profile).
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__)] + DIFF_PROFILE_GROUP_ARGS,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=600)
    print(proc.stdout.rstrip(), flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"[timing] diff: the profile's process exited "
                         f"{proc.returncode}")
    print(f"[diff] {time.perf_counter() - t_group:.1f} s for the group  "
          f"({card})", flush=True)

# ------------------------------------------------------------- CLI group
#: The [cli] group: the CLI sweep at the smoke's batch, kernel 1's and
#: kernel 2's ticks, and the per-instance closed loop that is logged and
#: replayed.
CLI_BATCH, CLI_TICKS, CLI_TICKS_LANES, CLI_TICKS_LOOP = 4096, 20, 3, 50
#: tools/batch_sweep.py's default batch, run in its default layout (vmap).
CLI_BATCH_VMAP = 512
ROOT = os.path.dirname(os.path.abspath(__file__))


def cli_main(argv):
    """``cli.main(argv)`` in this process: its exit code and what it
    printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def printed_json(out: str) -> dict:
    """The JSON object a subcommand printed before its "wrote ..." lines."""
    return json.loads(out.split("\nwrote ")[0])


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def run_cli(dev, card, tmp) -> dict:
    """The [cli] group: ``python -m cartpole_tpu_torch`` as a user starts
    it, and ``tools/batch_sweep.py``. Returns each kernel's launches in the
    group's in-process sweeps."""
    from cartpole_tpu_torch.tools import batch_sweep

    t_group = time.perf_counter()
    sweep = ["sweep", "--batch", str(CLI_BATCH), "--f32"]

    # sweep, lanes-fused (kernel 1), traced.
    res_fused = os.path.join(tmp, "sweep_fused.npz")
    ptu.set_tracing_enabled(True)
    ptu.TraceCollector.get_instance().clear()
    torch.cuda.synchronize()
    reset_counts()
    with ptu.trace_scope("cli sweep lanes-fused", batch=CLI_BATCH):
        rc, out = cli_main(sweep + ["--layout", "lanes-fused", "--steps",
                                    str(CLI_TICKS), "--results", res_fused])
    torch.cuda.synchronize()
    n_fused = counts()
    ptu.set_tracing_enabled(False)
    s_fused = printed_json(out)
    print(f"[cli] sweep --layout lanes-fused, {CLI_TICKS} ticks x batch "
          f"{CLI_BATCH}, f32: rc {rc}, launches {n_fused}, "
          f"{json.dumps(s_fused)}  ({card})", flush=True)
    if (rc != 0 or s_fused["n_failed_solves"] != 0
            or n_fused != dict(fused_iteration=CLI_TICKS, segment_jac=0)):
        raise SystemExit("[cli] the lanes-fused sweep failed or did not "
                         "launch kernel 1 once per tick")

    # sweep, lanes (kernel 2 once per GN iteration).
    torch.cuda.synchronize()
    reset_counts()
    rc, out = cli_main(sweep + ["--layout", "lanes", "--steps",
                                str(CLI_TICKS_LANES)])
    torch.cuda.synchronize()
    n_lanes = counts()
    s_lanes = printed_json(out)
    print(f"[cli] sweep --layout lanes, {CLI_TICKS_LANES} ticks x batch "
          f"{CLI_BATCH}, f32: rc {rc}, launches {n_lanes}, "
          f"{json.dumps(s_lanes)}  ({card})", flush=True)
    want = CLI_TICKS_LANES * pt.OptimizationParams().max_iterations
    if (rc != 0 or s_lanes["n_failed_solves"] != 0
            or n_lanes != dict(fused_iteration=0, segment_jac=want)):
        raise SystemExit("[cli] the lanes sweep failed or did not launch "
                         "kernel 2 once per GN iteration")

    # tools/batch_sweep.py --fused: per-scenario m_1 / l_1 (kernel 1).
    ckpt = os.path.join(tmp, "batch_sweep.npz")
    torch.cuda.synchronize()
    reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        s_grid, _ = batch_sweep.main(
            ["--batch", str(CLI_BATCH), "--steps", str(CLI_TICKS),
             "--fused", "--checkpoint", ckpt])
    torch.cuda.synchronize()
    n_grid = counts()
    print(f"[cli] tools/batch_sweep.py --fused, {CLI_TICKS} ticks x batch "
          f"{CLI_BATCH}, f32, a (m_1, l_1) grid: launches {n_grid}, "
          f"{json.dumps(s_grid)}, checkpoint {os.path.exists(ckpt)}  "
          f"({card})", flush=True)
    if (s_grid["n_failed_solves"] != 0 or not os.path.exists(ckpt)
            or n_grid != dict(fused_iteration=CLI_TICKS, segment_jac=0)):
        raise SystemExit("[cli] batch_sweep --fused failed or did not "
                         "launch kernel 1 once per tick")

    # tools/batch_sweep.py at its defaults: the example's vmap layout, no
    # kernel of the repo.
    torch.cuda.synchronize()
    reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        s_vmap, _ = batch_sweep.main(["--batch", str(CLI_BATCH_VMAP),
                                      "--steps", str(CLI_TICKS)])
    torch.cuda.synchronize()
    n_vmap = counts()
    print(f"[cli] tools/batch_sweep.py (the default layout, vmap), "
          f"{CLI_TICKS} ticks x batch {CLI_BATCH_VMAP}, f32, a (m_1, l_1) "
          f"grid: launches {n_vmap}, {json.dumps(s_vmap)}  ({card})",
          flush=True)
    if (s_vmap["n_failed_solves"] != 0
            or n_vmap != dict(fused_iteration=0, segment_jac=0)):
        raise SystemExit("[cli] batch_sweep's default vmap run failed or "
                         "launched a kernel of the repo")

    # The same lanes-fused sweep on two ranks of the one card (torchrun,
    # gloo), each taking half of the same states.
    res_ranks = os.path.join(tmp, "sweep_2ranks.npz")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_addr", "127.0.0.1", "--master_port",
         str(free_port()), "-m", "cartpole_tpu_torch"] + sweep
        + ["--layout", "lanes-fused", "--steps", str(CLI_TICKS),
           "--results", res_ranks],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall2 = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stderr[-3000:], file=sys.stderr)
        raise SystemExit("[cli] the two-rank sweep failed")
    s_ranks = printed_json(proc.stdout)
    a, b = np.load(res_fused), np.load(res_ranks)
    du = float(np.max(np.abs(a["controls"] - b["controls"])))
    same_codes = bool(np.array_equal(a["termination_states"],
                                     b["termination_states"]))
    diag_keys = sorted(k for k in a.files if k.startswith("diagnostics/"))
    same_diag = {k.split("/")[1]: bool(np.array_equal(a[k], b[k],
                                                      equal_nan=True))
                 for k in diag_keys}
    print(f"[cli] two ranks on one card (torchrun, gloo), {CLI_TICKS} ticks "
          f"x {CLI_BATCH // 2} each: {wall2:.1f} s for the command, sweep "
          f"wall_s {s_ranks['wall_s']}, solves_per_s "
          f"{s_ranks['solves_per_s']}, devices {s_ranks['devices']}; against "
          f"one rank: max |du| {du:.3e}, codes identical {same_codes}, "
          f"diagnostics equal {same_diag}  ({card})", flush=True)
    if s_ranks["devices"] != 2 or du != 0.0 or not same_codes \
            or not all(same_diag.values()):
        raise SystemExit("[cli] the two-rank sweep disagrees with one rank")

    # solve, a process of its own, on the card by default; it runs while
    # this process runs the closed loop, which is timed for no metric.
    t0 = time.perf_counter()
    solve = subprocess.Popen(
        [sys.executable, "-m", "cartpole_tpu_torch", "solve"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    # closed-loop, f64, the per-instance path, logged; then replay.
    log = os.path.join(tmp, "closed_loop.json")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rc, out = cli_main(["closed-loop", "--steps", str(CLI_TICKS_LOOP),
                        "--log-json", log])
    s_loop = printed_json(out)
    rc_r, out_r = cli_main(["replay", log])
    s_rep = printed_json(out_r)
    n_loop = counts()
    entries = json.load(open(log))
    print(f"[cli] closed-loop, {CLI_TICKS_LOOP} ticks, f64: rc {rc}, "
          f"n_failed {s_loop['n_failed']}, wall_s {s_loop['wall_s']}, "
          f"launches {n_loop}; replay: rc {rc_r}, ticks {s_rep['ticks']}, "
          f"n_failed {s_rep['n_failed']}, final_state is the log's last "
          f"{s_rep['final_state'] == entries[-1]['state']}; "
          f"{time.perf_counter() - t0:.1f} s  ({card})", flush=True)
    if (rc or rc_r or s_loop["n_failed"] or s_rep["n_failed"]
            or s_rep["ticks"] != CLI_TICKS_LOOP
            or s_rep["final_state"] != entries[-1]["state"]
            or any(n_loop.values())):
        raise SystemExit("[cli] closed-loop / replay failed")

    try:
        out, err = solve.communicate(timeout=600)
    finally:
        if solve.poll() is None:
            solve.kill()
    on = re.search(r"^device: (\S+),", out, re.M)
    print(f"[cli] solve: rc {solve.returncode}, device "
          f"{on.group(1) if on else None}, "
          f"{time.perf_counter() - t0:.1f} s beside the closed loop; "
          f"{out.splitlines()[0] if out else ''}", flush=True)
    if solve.returncode != 0 or not on or not on.group(1).startswith("cuda"):
        print(err[-3000:], file=sys.stderr)
        raise SystemExit("[cli] solve did not run on the card")

    # The trace of the lanes-fused sweep.
    trace = json.loads(ptu.TraceCollector.get_instance().get_trace_json())
    spans = [e for e in trace["traceEvents"]
             if e["name"] == "cli sweep lanes-fused"]
    print(f"[cli] trace_scope: {len(trace['traceEvents'])} events, the "
          f"sweep's span {spans[0]['dur'] / 1e6 if spans else None} s",
          flush=True)
    if len(spans) != 1:
        raise SystemExit("[cli] the trace does not hold the sweep's span")
    print(f"[cli] {time.perf_counter() - t_group:.1f} s for the group  "
          f"({card})", flush=True)
    return {"fused_iteration": (n_fused["fused_iteration"]
                                + n_grid["fused_iteration"]),
            "segment_jac": n_lanes["segment_jac"]}


# ------------------------------------------- the interactive demo and web
#: The [interactive] group's witness: the JAX package's run of
#: ``python -m cartpole_tpu interactive`` without a tty on a CPU (f64,
#: the CLI's defaults: window 40, spacing 10, 8 GN iterations; the pole
#: poked before tick 101), every 10th tick's solve-log entry
#: (scripts/probe_interactive_jax_cpu.py).
INTERACTIVE_WITNESS = os.path.join(ROOT, "interactive_jax_cpu.json")
#: The 1-based ticks whose log entries are held to the witness: the swing-up,
#: the tick before the poke, the recovery and the last. The tolerances are
#: the [oracle] gate's.
INTERACTIVE_CHECK_TICKS = (50, 100, 150, 200)
INTERACTIVE_DU, INTERACTIVE_DX = ORACLE_DU, ORACLE_DX
#: Replays of the interactive tick timed, rebuilds whose memory is
#: compared, and the wall seconds of the [web] realtime run.
INTERACTIVE_TIMED_TICKS, INTERACTIVE_REBUILDS, WEB_REALTIME_S = 10, 5, 10.0
#: The [triple-swingup] witness (scripts/probe_triple_tracked_jax_cpu.py):
#: tests/test_triple.py::TestTrackedSwingUp through the JAX package on a
#: CPU, f64. Its plan, and the replay's and catch's depths and gates.
TRIPLE_TRACKED_WITNESS = os.path.join(ROOT, "triple_tracked_jax_cpu.json")
TRIPLE_TRAJ = os.path.join(ROOT, "triple_swingup_traj.npz")
TRIPLE_CATCH_KWARGS = dict(
    window_length=60, state_spacing=5, max_iterations=8,
    th_final_cost_weight=150.0, th_dot_final_cost_weight=10.0,
    b_x_dot_final_cost_weight=10.0, u_guess_sinusoid_amplitude=0.0)
TRIPLE_CATCH_TICKS = 150
#: tests/test_triple.py:229-266: the mid-swing state's distance from the
#: plan, the final angle error and velocities.
TRIPLE_MID_TOL, TRIPLE_ANGLE_TOL, TRIPLE_VEL_TOL = 0.5, 1e-2, 0.1


def interactive_witness():
    with open(INTERACTIVE_WITNESS) as f:
        return json.load(f)


def triple_tracked_witness():
    with open(TRIPLE_TRACKED_WITNESS) as f:
        return json.load(f)


def entry_state(entry):
    """The single pole's packed state ``[b_x, th_1, b_x_dot, th_1_dot]``
    from a solve-log entry's ``initial_state``."""
    s = entry["initial_state"]
    return [s["b_x"], s["th_1"], s["b_x_dot"], s["th_1_dot"]]


def interactive_gate(entries, printed_final, witness):
    """The CLI's scripted run (its solve log ``entries``, one per tick, and
    the final state it printed) against the JAX package's
    (``interactive_jax_cpu.json``): at each of INTERACTIVE_CHECK_TICKS the
    tick's state within INTERACTIVE_DX, its ``u[0]`` within INTERACTIVE_DU
    and the same termination state; the printed final state equal to the
    witness's, both rounded to 4 decimals, within one unit of the last
    place."""
    if len(entries) != INTERACTIVE_CHECK_TICKS[-1]:
        return dict(n_entries=len(entries), ok=False)
    idx = [witness["ticks"].index(n) for n in INTERACTIVE_CHECK_TICKS]
    x = np.array([entry_state(entries[n - 1])
                  for n in INTERACTIVE_CHECK_TICKS])
    u = np.array([entries[n - 1]["u"][0] for n in INTERACTIVE_CHECK_TICKS])
    codes = [entries[n - 1]["solver_outputs"]["termination_state"]
             for n in INTERACTIVE_CHECK_TICKS]
    dx = float(np.abs(x - np.array(witness["states"])[idx]).max())
    du = float(np.abs(u - np.array(witness["u0"])[idx]).max())
    same_codes = codes == [witness["termination_states"][i] for i in idx]
    d_final = float(np.abs(np.asarray(printed_final)
                           - witness["final_state_printed"]).max())
    ok = (dx <= INTERACTIVE_DX and du <= INTERACTIVE_DU and same_codes
          and d_final <= 1e-4 + 1e-9)
    return dict(max_abs_dx=dx, max_abs_du=du, codes_equal=same_codes,
                printed_final_dx=d_final, ok=bool(ok))


def triple_tracked_gate(x_mid, x_plan, codes, xf):
    """tests/test_triple.py::TestTrackedSwingUp's gates (numpy arrays): the
    mid-swing state within TRIPLE_MID_TOL of the plan, no QP_INDEFINITE or
    MAX_LAMBDA code in the catch, every link within TRIPLE_ANGLE_TOL of
    upright and every velocity below TRIPLE_VEL_TOL at its end."""
    mid = float(np.abs(x_mid - x_plan).max())
    ang = float(_upright_error(xf[1:4]).max())
    vel = float(np.abs(xf[4:]).max())
    checks = dict(
        mid_swing_on_plan=mid < TRIPLE_MID_TOL,
        no_failed_solve=not bool(np.any((codes == 3) | (codes == 4))),
        final_upright=ang < TRIPLE_ANGLE_TOL,
        final_at_rest=vel < TRIPLE_VEL_TOL)
    return dict(checks, ok=all(checks.values()), mid_swing_dx=mid,
                final_angle_error=ang, final_max_abs_velocity=vel)


def eager_tick(loop):
    """The loop's next tick as eager calls on its current inputs (plant
    state, warm start, dynamics parameters, set point, poke forces):
    ``MPC.step`` and the plant step, or the plant step alone with the
    controller off. Returns ``(x_next, previous_solution, warm, u)``."""
    dt, dev, dtype = loop.params.control_dt, loop.device, loop.dtype
    f = torch.tensor(loop.forces, dtype=dtype, device=dev)
    st = loop.mpc_state
    if loop.enabled:
        out, st = loop.mpc.step(st, loop.x, loop.dp, torch.tensor(
            float(loop.set_point), dtype=dtype, device=dev))
        u, u0 = out.u, out.u[0]
    else:
        u = None
        u0 = torch.zeros((), dtype=dtype, device=dev)
    x_next = pt.simulator_step(
        loop.dp, loop.x, dt, u0, f_base=f[0], f_mass=f[1], model=loop.model,
        f_mass_2=f[2] if len(f) > 2 else None)
    return x_next, st.previous_solution, st.warm, u


def same_tick(a, b):
    return all((p is None and q is None) or (
        p is not None and q is not None and torch.equal(p, q))
        for p, q in zip(a, b))


def run_interactive(dev, card, tmp):
    """[interactive]: the CLI's scripted run as a process of its own,
    against the JAX package's, while an InteractiveLoop is driven through
    each mutation, every replayed tick after one held to the eager tick on
    the same inputs; then, with the CLI's process ended, the replayed
    tick's and a rebuild's time and the card's memory over rebuilds. No
    kernel of the repo lies on this path."""
    t_group = time.perf_counter()
    log = os.path.join(tmp, "interactive_log.json")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "cartpole_tpu_torch", "interactive",
         "--log-json", log], cwd=ROOT, stdin=subprocess.DEVNULL,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    try:
        reset_counts()
        loop = check_mutations(dev, card)
        out, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(err[-3000:], file=sys.stderr)
        raise SystemExit("[interactive] the CLI's scripted run failed")
    m = re.search(r"^final state: (\[.*\])$", out, re.M)
    entries = json.load(open(log))
    g = interactive_gate(entries, json.loads(m.group(1)) if m else [math.nan],
                         interactive_witness())
    print(f"[interactive] python -m cartpole_tpu_torch interactive (no tty: "
          f"200 ticks, the pole poked before tick 101), f64, window 40, a "
          f"process of its own: {wall:.1f} s; ticks "
          f"{list(INTERACTIVE_CHECK_TICKS)} against the JAX package's run "
          f"(interactive_jax_cpu.json): {json.dumps(g)}, gate states atol "
          f"{INTERACTIVE_DX:g}, max |du| <= {INTERACTIVE_DU:g}, equal "
          f"codes; printed {m.group(1) if m else None}  ({card})",
          flush=True)
    if not g["ok"]:
        raise SystemExit("[interactive] the CLI's run departs from the JAX "
                         "package's")
    time_interactive(loop, card)
    n_launch = counts()
    if any(n_launch.values()):
        raise SystemExit(f"[interactive] launched a kernel of the repo: "
                         f"{n_launch}")
    print(f"[interactive] {time.perf_counter() - t_group:.1f} s for the "
          f"group  ({card})", flush=True)


def check_mutations(dev, card):
    """An InteractiveLoop on the card (f64, its default params) through
    each mutation, every replayed tick after one held to the eager tick on
    the same inputs, and to differ from the tick of the unchanged inputs
    where the mutation is an input. Returns the loop."""
    from cartpole_tpu_torch.interactive import InteractiveLoop

    f64 = torch.float64
    loop = InteractiveLoop(dtype=f64, render=False)
    loop.x = torch.tensor([0.05, math.pi / 2 + 0.1, 0.0, 0.0], dtype=f64,
                          device=dev)
    loop.tick()  # eager, and captured

    mutations = (
        ("poke (p)", lambda: loop.handle_command("p"), True),
        ("set_dynamics(m_1=0.13)", lambda: loop.set_dynamics(m_1=0.13), True),
        ("set point 0.2", lambda: setattr(loop, "set_point", 0.2), True),
        ("t (rebuild)", lambda: loop.handle_command("t"), False),
        ("c (off)", lambda: loop.handle_command("c"), False),
        ("c (on)", lambda: loop.handle_command("c"), False),
        ("r (reset)", lambda: loop.handle_command("r"), False),
    )
    results = {}
    for name, mutate, stale_check in mutations:
        stale = eager_tick(loop) if stale_check else None
        mutate()
        ticks = loop._mpc_tick if loop.enabled else loop._plant_tick
        if ticks.graph is None:
            loop.tick()  # a build's first tick: eager, and captured
        fresh = eager_tick(loop)
        out = loop.tick()
        got = (loop.x, loop.mpc_state.previous_solution, loop.mpc_state.warm,
               None if out is None else out.u)
        r = dict(replayed=ticks.graph is not None,
                 equals_eager=same_tick(got, fresh))
        if stale is not None:
            r["differs_from_unchanged_inputs"] = not same_tick(got, stale)
        results[name] = r
    ok = all(r["replayed"] and r["equals_eager"]
             and r.get("differs_from_unchanged_inputs", True)
             for r in results.values())
    print(f"[interactive] mutations, f64, the loop's default params (window "
          f"40, spacing 5, 8 iterations): each replayed "
          f"tick against MPC.step and the plant step run eagerly on the "
          f"same inputs (bit for bit): {json.dumps(results)}  ({card})",
          flush=True)
    if not ok:
        raise SystemExit("[interactive] a replayed tick departs from the "
                         "eager tick, or a change did not reach the graph")
    return loop


def time_interactive(loop, card):
    """A replayed tick of ``loop`` as the demo runs it (solve, plant, log),
    its graph's replay alone, and beside them a replay of
    ``run_closed_loop``'s tick (``tick_fn``) at the same params; a rebuild
    up to its first replay; ``torch.cuda.memory_allocated`` after each of
    INTERACTIVE_REBUILDS rebuilds, and after each of as many
    ``run_closed_loop`` calls (each captures a graph of its own), which
    may not grow."""
    ms = tick_ms(loop.tick, INTERACTIVE_TIMED_TICKS)
    graph = loop._mpc_tick.graph.graph
    replay_ms = tick_ms(graph.replay, INTERACTIVE_TIMED_TICKS)
    prof = profile_calls(loop.tick)
    same = time_per_instance(loop.mpc, loop.dp, (
        loop.x, loop.mpc_state.previous_solution, loop.mpc_state.warm),
        n=INTERACTIVE_TIMED_TICKS)
    alloc = []
    rebuild_ms = []
    for _ in range(INTERACTIVE_REBUILDS):
        torch.cuda.synchronize()
        t0r = time.perf_counter()
        loop.handle_command("t")
        t1r = time.perf_counter()
        loop.tick()
        torch.cuda.synchronize()
        t2r = time.perf_counter()
        loop.tick()
        torch.cuda.synchronize()
        t3r = time.perf_counter()
        rebuild_ms.append(((t1r - t0r) * 1e3, (t2r - t1r) * 1e3,
                           (t3r - t2r) * 1e3))
        gc.collect()
        alloc.append(torch.cuda.memory_allocated())
    loop_alloc = []
    for _ in range(INTERACTIVE_REBUILDS):
        cl.run_closed_loop(loop.mpc, loop.x, loop.dp, num_steps=2)
        gc.collect()
        loop_alloc.append(torch.cuda.memory_allocated())
    n_launch = counts()
    mem_ok = alloc[-1] <= alloc[0] and loop_alloc[-1] <= loop_alloc[0]
    rebuild = np.median(np.array(rebuild_ms), axis=0)
    print(f"[timing] interactive, single f64, window 40, spacing 5: a "
          f"replayed tick (inputs in, replay, outputs out, the log entry) "
          f"{float(np.median(ms)):.2f} ms median of "
          f"{INTERACTIVE_TIMED_TICKS}, its graph's replay alone "
          f"{float(np.median(replay_ms)):.2f} ms; one tick under "
          f"torch.profiler {json.dumps(prof)}; run_closed_loop's tick at "
          f"the same params, replayed: {same['graph_ms']:.2f} ms, under "
          f"torch.profiler {json.dumps(same['graph_profile'])}; a rebuild "
          f"(t), medians over "
          f"{INTERACTIVE_REBUILDS}: the MPC {rebuild[0]:.1f} ms, its first "
          f"tick (eager, and captured) {rebuild[1]:.1f} ms, its second "
          f"tick (the first replay) {rebuild[2]:.1f} ms, "
          f"{float(np.median([sum(r) for r in rebuild_ms])):.1f} ms to its "
          f"first replay; "
          f"torch.cuda.memory_allocated after rebuild 1 {alloc[0]} B, after "
          f"rebuild {INTERACTIVE_REBUILDS} {alloc[-1]} B (all: {alloc}); "
          f"after run_closed_loop (2 ticks) call 1 {loop_alloc[0]} B, after "
          f"call {INTERACTIVE_REBUILDS} {loop_alloc[-1]} B (all: "
          f"{loop_alloc}); launches {n_launch}  ({card})", flush=True)
    if not mem_ok:
        raise SystemExit("[interactive] the card's memory grows over "
                         "rebuilds or run_closed_loop calls")


def http(base, path, payload=None):
    """GET ``path`` (POST ``payload`` as JSON when given): the status and
    the body, parsed as JSON unless it is the page or empty (``/traces``
    while tracing is off)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        base + path, method="GET" if payload is None else "POST",
        data=None if payload is None else json.dumps(payload).encode())
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            status, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    return status, (json.loads(body) if body and path != "/"
                    else body.decode())


#: Every route once, then malformed bodies: (method path, body, status).
WEB_ROUTES = (
    ("/", None, 200), ("/state", None, 200), ("/tick", {"n": 3}, 200),
    ("/poke", {"mass_index": 1, "incident_angle": 0.0}, 200),
    ("/dynamics", {"m_1": 0.12}, 200),
    ("/control", {"set_point": 0.1, "sim_rate": 1.0}, 200),
    ("/tick", {"n": 1}, 200),
    ("/optimization", {"th_final_cost_weight": 120.0}, 200),
    ("/tick", {"n": 2}, 200), ("/reset", {}, 200),
    ("/control", {"enabled": False}, 200), ("/tick", {"n": 2}, 200),
    ("/control", {"enabled": True}, 200), ("/tick", {"n": 1}, 200),
    ("/log", None, 200),
    ("/traces", None, 200), ("/leak", None, 200), ("/nope", None, 404),
    ("/poke", {"incident_angle": 0.0}, 400),
    ("/poke", {"mass_index": "zero", "incident_angle": 0.0}, 400),
    ("/dynamics", {"m_1": "heavy"}, 400), ("/dynamics", {"nope": 1.0}, 400),
    ("/optimization", {"u_cost_weight": True}, 400),
    ("/optimization", {"kkt_method": "qr"}, 400),
    ("/optimization", {"window_length": 40.5}, 400),
    ("/optimization", {"window_length": -3}, 400),
    ("/optimization", {"bogus": 1.0}, 400),
    ("/control", {"enabled": "yes"}, 400), ("/tick", {"n": 0}, 400),
    ("/reset", {"hard": True}, 400), ("/control", [1, 2], 400),
)


def run_web(dev, card):
    """[web]: a WebApp on port 0 on the card, every route once and the 400s
    of malformed bodies; then its realtime tick thread for WEB_REALTIME_S
    of wall time: simulated seconds per wall second. No kernel of the repo
    lies on this path."""
    from cartpole_tpu_torch.interactive import InteractiveLoop
    from cartpole_tpu_torch.web import WebApp

    t_group = time.perf_counter()
    reset_counts()
    app = WebApp(loop=InteractiveLoop(dtype=torch.float64, render=False),
                 realtime=False)
    host, port = app.start("127.0.0.1", 0)
    base = f"http://{host}:{port}"
    got = []
    try:
        for path, body, want in WEB_ROUTES:
            status, _ = http(base, path, body)
            got.append((path, status, want))
        snap = http(base, "/state")[1]
    finally:
        app.stop()
    bad = [g for g in got if g[1] != g[2]]
    ok = (not bad and snap["tick"] == 9 and snap["enabled"]
          and snap["optimization"]["th_final_cost_weight"] == 120.0
          and abs(snap["dynamics"]["m_1"] - 0.12) < 1e-12
          and snap["predicted"] is not None)
    print(f"[web] WebApp on the card, {len(WEB_ROUTES)} requests (every "
          f"route, the 400s of malformed bodies, /optimization's "
          f"included): {len(got) - len(bad)} with the expected status, "
          f"wrong: {bad}; /state after them: tick {snap['tick']}, "
          f"x {snap['x']}, error {snap['error']}  ({card})", flush=True)
    if not ok:
        raise SystemExit("[web] a route answered wrongly")

    # Realtime: the tick thread builds, captures and replays under the
    # app's lock while this thread polls /state and /leak.
    app = WebApp(loop=InteractiveLoop(dtype=torch.float64, render=False),
                 realtime=True)
    host, port = app.start("127.0.0.1", 0)
    base = f"http://{host}:{port}"
    lp = app.loop
    try:
        deadline = time.perf_counter() + 120
        polls = 0
        while lp._mpc_tick.graph is None and time.perf_counter() < deadline:
            polls += http(base, "/state")[0] == 200
            polls += http(base, "/leak")[0] == 200
        n0, t0 = lp.tick_count, time.perf_counter()
        time.sleep(WEB_REALTIME_S)
        n1, t1 = lp.tick_count, time.perf_counter()
        snap = http(base, "/state")[1]
    finally:
        app.stop()
    n_launch = counts()
    rate = (n1 - n0) * lp.params.control_dt / (t1 - t0)
    print(f"[web] realtime, single f64, window 40: {n1 - n0} ticks in "
          f"{t1 - t0:.2f} s of wall time, sim_s_per_wall_s {rate:.4f}; "
          f"{polls} polls of /state and /leak answered while the tick "
          f"thread captured; error {snap['error']}; launches {n_launch}  "
          f"({card})", flush=True)
    if lp._mpc_tick.graph is None or n1 <= n0 or snap["error"]:
        raise SystemExit("[web] the realtime tick thread did not replay")
    if any(n_launch.values()):
        raise SystemExit(f"[web] launched a kernel of the repo: {n_launch}")
    print(f"[web] {time.perf_counter() - t_group:.1f} s for the group  "
          f"({card})", flush=True)


def run_triple_swingup(dev, card):
    """[triple-swingup]: tests/test_triple.py::TestTrackedSwingUp on the
    card: the plan's first controls replayed open loop (one plant step
    captured in a CUDA graph and replayed), then run_closed_loop's catch;
    its gates, and both states beside the JAX package's. No kernel of the
    repo lies on this path."""
    t_group = time.perf_counter()
    f64 = torch.float64
    traj = np.load(TRIPLE_TRAJ)
    K = int(traj["window"])
    handoff = K - 60
    u_ref = torch.as_tensor(np.asarray(traj["u"], np.float64)[:handoff],
                            device=dev)
    x_plan = np.asarray(traj["solution"])[: (K // 20 + 1) * 8].reshape(
        -1, 8)[handoff // 20]
    dp = pt.default_triple_params(f64, dev)
    up = math.pi / 2
    hang = torch.tensor([0.0, -up, -up, -up, 0.0, 0.0, 0.0, 0.0], dtype=f64,
                        device=dev)
    model = pt.TRIPLE_CARTPOLE

    def plant(x, u):
        return (pt.simulator_step(dp, x, 0.01, u, model=model),)

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    eager_first = plant(hang, u_ref[0])[0]
    step = cl.CUDAGraphTick(plant, (hang, u_ref[0]))
    x = hang
    for t in range(handoff):
        x = step(x, u_ref[t])[0]
        if t == 0:
            first_same = torch.equal(x, eager_first)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    x_mid = x
    mpc = pt.make_mpc(pt.OptimizationParams(**TRIPLE_CATCH_KWARGS), model)
    t0 = time.perf_counter()
    res = pt.run_closed_loop(mpc, x_mid, dp, TRIPLE_CATCH_TICKS)
    torch.cuda.synchronize()
    catch_s = time.perf_counter() - t0
    n_launch = counts()
    xm, xf = x_mid.cpu().numpy(), res.final_state.cpu().numpy()
    codes = res.termination_states.cpu().numpy()
    g = triple_tracked_gate(xm, x_plan, codes, xf)
    w = triple_tracked_witness()
    ticks = w["catch_ticks"]
    states = res.states.cpu().numpy()
    d_states = {t: float(np.abs(states[t] - s).max())
                for t, s in zip(ticks, w["catch_states"]) if t < len(states)}
    print(f"[triple-swingup] f64: {handoff} planned controls of "
          f"triple_swingup_traj.npz replayed open loop (a plant step "
          f"captured in a CUDA graph, its first replay the eager step's "
          f"bits: {first_same}) in {replay_s:.2f} s, then run_closed_loop "
          f"(window 60, spacing 5, 8 iterations, soft terminal weights) for "
          f"{TRIPLE_CATCH_TICKS} ticks in {catch_s:.2f} s, termination codes "
          f"{np.bincount(codes, minlength=5).tolist()}; gates of "
          f"tests/test_triple.py: {json.dumps(g)}; launches {n_launch}  "
          f"({card})", flush=True)
    print(f"[triple-swingup] beside the JAX package's run "
          f"(triple_tracked_jax_cpu.json): mid-swing state "
          f"{np.round(xm, 6).tolist()} against "
          f"{np.round(w['x_mid'], 6).tolist()}, max |dx| "
          f"{float(np.abs(xm - w['x_mid']).max()):.3e}; the catch's states, "
          f"max |dx| by tick {json.dumps(d_states)}; final state "
          f"{np.round(xf, 6).tolist()} against "
          f"{np.round(w['final_state'], 6).tolist()}, max |dx| "
          f"{float(np.abs(xf - w['final_state']).max()):.3e}  ({card})",
          flush=True)
    if not g["ok"] or not first_same:
        raise SystemExit("[triple-swingup] its gates failed")
    if any(n_launch.values()):
        raise SystemExit(f"[triple-swingup] launched a kernel of the repo: "
                         f"{n_launch}")
    print(f"[triple-swingup] {time.perf_counter() - t_group:.1f} s for the "
          f"group  ({card})", flush=True)


def run_interactive_groups(dev, card):
    """The [interactive], [web] and [triple-swingup] groups, in this order
    (``python chip_smoke.py --group interactive``)."""
    tmp = os.path.join(ROOT, "chiprun_out", "interactive")
    os.makedirs(tmp, exist_ok=True)
    run_interactive(dev, card, tmp)
    run_web(dev, card)
    run_triple_swingup(dev, card)


#: The argument that runs only the [diff] group: ``run`` starts it as a
#: process of its own from the end of the build.
DIFF_GROUP_ARGS = ["--group", "diff"]
#: The argument that runs only the [diff] group's profile: the group starts
#: it as a process of its own at its end (``run_diff_profile``).
DIFF_PROFILE_GROUP_ARGS = ["--group", "diff-profile"]
#: The argument that runs only the [interactive], [web] and
#: [triple-swingup] groups: ``run`` starts them as a process of their own
#: beside the build and the single's, double's and triple's paths.
INTERACTIVE_GROUP_ARGS = ["--group", "interactive"]
#: The argument that runs only the [per-instance] group: ``run`` starts it
#: as a process of its own once the kernels are built.
PER_INSTANCE_GROUP_ARGS = ["--group", "per-instance"]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if argv == DIFF_GROUP_ARGS:
        strict_vmap()
        run_diff(dev, _card())
        return 0
    if argv == DIFF_PROFILE_GROUP_ARGS:
        strict_vmap()
        run_diff_profile(dev, _card())
        return 0
    if argv == INTERACTIVE_GROUP_ARGS:
        run_interactive_groups(dev, _card())
        return 0
    if argv == PER_INSTANCE_GROUP_ARGS:
        strict_vmap()
        run_per_instance(dev, _card())
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    return run(dev)


def strict_vmap():
    """A batching rule that ``torch.func.vmap`` lacks would run a batch as
    a loop over its instances: its warning is an error here."""
    warnings.filterwarnings("error", message="There is a performance drop")


def start_group(group_args, log_path):
    """A group (``python chip_smoke.py --group ...``) as a process of its
    own, its output into ``log_path``. The [diff] and [interactive] groups
    launch no kernel of the repo and, like the runs beside them, keep the
    host busy and the card idle most of the time (PERF.md §5)."""
    with open(log_path, "w") as log_f:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)] + group_args,
            cwd=ROOT, stdout=log_f, stderr=subprocess.STDOUT,
            start_new_session=True)


def join_group(proc, log_path, name, timeout=1200):
    """Wait for a group's process, print its output and fail if it
    failed (or outlived ``timeout``)."""
    rc = proc.wait(timeout=timeout)
    with open(log_path) as f:
        print(f.read(), end="", flush=True)
    if rc != 0:
        raise SystemExit(f"[{name}] the group's process exited {rc}")


def run(dev) -> int:
    """Every phase on ``dev``; raises ``SystemExit`` on the first failed
    gate. A group's process still running then is stopped."""
    children = []
    try:
        return run_phases(dev, children)
    finally:
        for proc in children:
            # The group's session: the group and what it started.
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def run_phases(dev, children) -> int:
    """The phases of ``run``; each group's process started goes into
    ``children``."""
    strict_vmap()
    # ---------------------------------------------------------------- device
    card = _card()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t_start = time.perf_counter()

    def elapsed(phases):
        print(f"[elapsed] {time.perf_counter() - t_start:.1f} s after "
              f"{phases}", flush=True)

    # The interactive demo's groups need no kernel: a process of their own
    # from the start, beside the build and the single's, double's and
    # triple's paths.
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    interactive_log = os.path.join(out_dir, "interactive_group.log")
    interactive = start_group(INTERACTIVE_GROUP_ARGS, interactive_log)
    children.append(interactive)

    # ----------------------------------------------------------------- build
    t0 = time.perf_counter()
    path, log = _build.build_library()
    build_s = time.perf_counter() - t0
    _build.load_library()
    print(f"[build] {build_s:.1f} s -> {os.path.relpath(path)}; seconds "
          f"per source: {' '.join(re.findall(r'^== (.*)$', log, re.M))}",
          flush=True)
    if not log:
        print("[build] the library was built before: no ptxas report",
              flush=True)
    if log:
        build_report(ptxas_entries(log))
    elapsed("the build")

    # The per-instance group (its [vmap] comparison with path 2 needs the
    # kernels just built): a process of its own beside the single's paths.
    per_instance_log = os.path.join(out_dir, "per_instance_group.log")
    per_instance = start_group(PER_INSTANCE_GROUP_ARGS, per_instance_log)
    children.append(per_instance)
    # The diff group (no kernel of the repo) from here too: with its
    # replayed gradients and the 120 sysid steps it takes ~500 s, which
    # started after the single's paths would outlast the triple's phases.
    diff_log = os.path.join(out_dir, "diff_group.log")
    diff = start_group(DIFF_GROUP_ARGS, diff_log)
    children.append(diff)

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

    check_bitwise("single, path 1", eager_ticks(
        mpc, res1.final_state, dp, BITWISE_TICKS, True,
        res1.final_mpc_state), res, card)

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
    # The same force over ticks 1-3 of a short run: two of them replayed.
    dist5 = torch.zeros((B, BITWISE_TICKS, 2, 2), device=dev)
    dist5[:, 1:4, 1, 0] = 4.0
    check_bitwise("single, path 1, disturbed", eager_ticks(
        mpc, res.final_state, dp, BITWISE_TICKS, True, res.final_mpc_state,
        dist5), pt.run_closed_loop_lanes(
            mpc, res.final_state, dp, BITWISE_TICKS,
            mpc_state=res.final_mpc_state, disturbances=dist5, fused=True),
        card)

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

    check_bitwise("single, path 2", eager_ticks(
        mpc, x0, dp, BITWISE_TICKS, False), res2, card)

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

    # ---------------- the double and triple poles, the groups beside them
    tmp = os.path.join(out_dir, "cli")
    os.makedirs(tmp, exist_ok=True)
    checks_d = check_multilink_kernels(pt.DOUBLE_CARTPOLE, dev, card)
    run_d = run_double(dev, card, checks_d["floor"])
    elapsed("the double's phases")
    checks_t = check_multilink_kernels(pt.TRIPLE_CARTPOLE, dev, card)
    run_t = run_triple(dev, card)
    elapsed("the triple's phases")
    join_group(per_instance, per_instance_log, "per-instance")
    elapsed("the per-instance group (its own process, beside the single's "
            "paths)")
    join_group(interactive, interactive_log, "interactive")
    elapsed("the interactive, web and triple-swingup groups (their own "
            "process, beside the build and the single's, double's and "
            "triple's paths)")
    join_group(diff, diff_log, "diff")
    elapsed("the diff group (its own process, beside the single's, "
            "double's and triple's paths)")
    n_cli = run_cli(dev, card, tmp)
    elapsed("the cli group")
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
    time_graphed("single, path 1", mpc, dp, res, True, med_tick, card)
    time_graphed("single, path 2", mpc, dp, res2, False, med_tick2, card)
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
            "launches": n1["fused_iteration"] + n_cli["fused_iteration"],
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
            "launches": n2["segment_jac"] + n_cli["segment_jac"],
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
