"""Time kernel 1 on the card over its launch layouts, and profile its stages.

Builds the kernel library once for each lanes-per-instance value and
register cap of ``VARIANTS`` (``-DFUSED_LANES``, ``-maxrregcount``), all
builds at once, and times one 8-iteration solve at the bench point of
``chip_smoke.py`` (batch 4096, window 40, spacing 5) for each build and
each count of instances per block in ``INSTANCES``: on the cold-start
problem and on the warm problem after ``WARM_TICKS`` ticks of path 1. Every
output of every layout must equal the default build's bit for bit: each
output is computed whole by one lane, so the layout changes no arithmetic.
The default build is also held against the plain version on the cold start
under ``chip_smoke.py``'s strict gate. A build with ``-DFUSED_PROFILE``
then counts, per step of an iteration, the cycles lane 0 of each instance
spends in it (barrier included) on both problems. Prints one JSON line per
layout and per profiled step with the card's name and power limit.

Usage, from the repository root:
    python3 -m cartpole_tpu_torch.tools.sweep_fused_layout
Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import sys

import torch

import chip_smoke as cs
import cartpole_tpu_torch as pt
from cartpole_tpu_torch.mpc import lanes
from cartpole_tpu_torch.ops import _build, fused
from cartpole_tpu_torch.ops import pallas_kernels as pk

#: (lanes per instance, None, a register cap, or a macro to define).
VARIANTS = ((16, None), (32, None), (8, None))
INSTANCES = (2, 4, 8, 10, 16, 20, 32)
#: Lanes per instance of the profiling build.
PROFILE_LANES = 16
WARM_TICKS = 20


def _flags(lanes, opt):
    extra = ([] if opt is None else [f"-D{opt}"] if isinstance(opt, str)
             else [f"-maxrregcount={opt}"])
    return [f"-DFUSED_LANES={lanes}"] + extra


def _step_names(n_all):
    """Names of the fixed steps of an active iteration, by profile index
    (csrc/fused_iteration.cuh::solve_instance); the line-search rounds,
    finish and accept follow."""
    names = ["linearize", "condense", "project", "spectral", "cig"]
    for j in range(n_all):
        names += [f"qr {kind} {i}-{j}" for _ in range(2) for i in range(j)
                  for kind in ("dot", "axpy")]
        names += [f"qr norm {j}", f"qr scale {j}"]
    if n_all:
        names += ["rhs1", "schur1", "du1", "qt du", "residuals", "qt res",
                  "cird", "rhs2", "schur2", "du2"]
    return names + ["post", "merit"]


def _problem(mpc, state, x):
    problem, Z0 = cs.setup_problem(mpc, state, x, torch.float32)
    args = (problem.statics.fused, problem.dynamics_params, problem.x_current,
            problem.set_point, problem.u_prev)
    return args, lanes._init_carry(Z0, mpc.nls_config)


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_fused_layout: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = cs._card()
    print(f"card: {card}", flush=True)
    prof = (PROFILE_LANES, "FUSED_PROFILE")
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS) + 1) as ex:
        jobs = {v: ex.submit(_build.build_library, _flags(*v))
                for v in VARIANTS + (prof,)}
        builds = {v: j.result() for v, j in jobs.items()}
    libs = {v: _build.open_library(path) for v, (path, _) in builds.items()}
    for v, (_, log) in builds.items():
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "fused_iteration" in line:
                print(f"[build] lanes {v[0]} cap {v[1]}: "
                      + " | ".join(x.strip() for x in lines[i:i + 4]),
                      flush=True)

    B = cs.BATCH
    mpc = pt.make_mpc(pt.OptimizationParams(
        max_iterations=8, state_spacing=5, kkt_method="condensed"))
    n_iter = mpc.nls_config.max_iterations
    dp = pt.default_single_params(torch.float32, dev)
    x0 = torch.as_tensor(cs.make_x0s("single", B), dtype=torch.float32,
                         device=dev)
    cold = pt.MPCState(
        previous_solution=torch.zeros((B, mpc.spec.dim), device=dev),
        warm=torch.zeros((B,), dtype=torch.bool, device=dev))

    r = cs.compare(mpc, cold, x0)
    cs.check_compare("sweep: cold, tick 0", r, "strict", card)
    res = pt.run_closed_loop_lanes(mpc, x0, dp, WARM_TICKS, fused=True)
    problems = {"cold": _problem(mpc, cold, x0),
                f"tick {WARM_TICKS}": _problem(mpc, res.final_mpc_state,
                                               res.final_state)}
    base = (VARIANTS[0], fused.INSTANCES_PER_BLOCK)
    ref = {name: fused._launch_cuda(*args, carry, n_iter, libs[base[0]],
                                    base[0][0], base[1])
           for name, (args, carry) in problems.items()}

    def same(a, b):
        return all(torch.equal(x.nan_to_num(), y.nan_to_num())
                   for x, y in zip(a[0] + a[1], b[0] + b[1]))

    ok = True
    st = problems["cold"][0][0]
    for v in VARIANTS:
        for w in INSTANCES:
            smem = 4 * (fused.statics_reals(st)
                        + w * fused.workspace_reals(st, v[0]))
            if smem > fused.SMEM_BLOCK_MAX or w * v[0] > 1024:
                continue
            row = dict(option=v[1], **fused.kernel_occupancy(
                problems["cold"][0][0], B, w, libs[v]))
            if not row["blocks_per_sm"]:  # the block needs too many registers
                print(f"[layout] {json.dumps(row)}  ({card})", flush=True)
                continue
            for name, (args, carry) in problems.items():
                def launch():
                    return fused._launch_cuda(*args, carry, n_iter, libs[v],
                                              v[0], w)
                row[f"ms_{name}"] = cs.time_cuda(launch, 10)
                row[f"identical_{name}"] = same(launch(), ref[name])
                ok &= row[f"identical_{name}"]
            print(f"[layout] {json.dumps(row)}  ({card})", flush=True)

    lib = libs[prof]
    lib.fused_iteration_profile.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.fused_iteration_profile.restype = ctypes.c_int
    names = _step_names(st.n_tc + st.n_t)
    for name, (args, carry) in problems.items():
        buf = torch.zeros(2 * 128, dtype=torch.int64, device=dev)
        model = pk.KERNEL_MODELS.index(st.model)
        if lib.fused_iteration_profile(model, buf.data_ptr()) != 0:
            raise SystemExit("profile buffer not set")
        out = fused._launch_cuda(*args, carry, n_iter, lib, PROFILE_LANES,
                                 fused.INSTANCES_PER_BLOCK)
        torch.cuda.synchronize()
        lib.fused_iteration_profile(model, None)
        ok &= same(out, ref[name])
        cyc, calls = buf[0::2].tolist(), buf[1::2].tolist()
        total = sum(cyc)
        for i in range(128):
            if calls[i]:
                label = (names[i] if i < len(names) else
                         "frozen" if i >= 96 else "line search, finish")
                row = dict(problem=name, step=i, name=label,
                           calls=calls[i], mean_cycles=cyc[i] / calls[i],
                           share=cyc[i] / total)
                print(f"[profile] {json.dumps(row)}  ({card})", flush=True)
    if not ok:
        raise SystemExit("a layout changed the kernel's outputs")
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
