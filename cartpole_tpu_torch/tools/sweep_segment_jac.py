"""Time kernel 2 on the card over its block sizes, beside another build of it.

Times one f32 launch of ``csrc/segment_jac.cu`` at the bench point of
``chip_smoke.py`` (R = 8 segments x batch 4096 = 32768 columns, 5 RK4 steps
each) for each count of threads per block in ``THREADS``: on the cold-start
shooting problem and on the warm linearization after ``WARM_TICKS`` ticks of
path 2, by the kernel's device time (``chip_smoke.device_ms``: every launch
taking its turn in each of 7 rounds, medians). Every block size must give
the default block's outputs bit for bit (one thread computes a column
whole), in f32 on both problems and in f64 on the cold one; the default is
also held against the plain version under ``chip_smoke.py``'s gates.

With ``--against DIR``, kernel 2 of another checkout of the repository
(``DIR/cartpole_tpu_torch/csrc``, built from its ``segment_jac*`` units as
``ops/_build.py`` builds them here; its C launchers take the same
arguments, the model id first) is built too, in parallel, and timed in the same rounds at the same block sizes; whether its
outputs have this build's bits is printed. That is how two designs are
compared on one card in one process. Prints one JSON line per build and
block size with the card's name and power limit, and the SM clock before
the timing.

Usage, from the repository root:
    python3 -m cartpole_tpu_torch.tools.sweep_segment_jac [--against DIR]
Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import sys

import torch

import chip_smoke as cs
import cartpole_tpu_torch as pt
from cartpole_tpu_torch.mpc import lanes
from cartpole_tpu_torch.ops import _build
from cartpole_tpu_torch.ops import pallas_kernels as pk

THREADS = (32, 64, 128)
WARM_TICKS = 20


def _build_other(root: str) -> ctypes.CDLL:
    """Kernel 2 of the checkout at ``root``, alone in a shared library
    (its ``segment_jac*`` units of ``_build.device_units``)."""
    path, _ = _build.build_library(
        csrc=os.path.join(root, "cartpole_tpu_torch", "csrc"),
        prefix="segment_jac")
    lib = ctypes.CDLL(path)
    _build.check_models(lib)
    for name, real in (("segment_jac_launch_f32", ctypes.c_float),
                       ("segment_jac_launch_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 2 + [real] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _launch(lib, inputs, h, angle, threads):
    """One launch of ``lib``'s kernel 2 on ``inputs`` in blocks of
    ``threads``, through its C launcher."""
    p, xs, us = inputs
    R, sp = xs.shape[1], us.shape[0]
    sd = xs.shape[0]
    outs = (torch.empty_like(xs), xs.new_empty((sd, sd, R)),
            xs.new_empty((sd, sp, R)))
    fn = (lib.segment_jac_launch_f32 if xs.dtype == torch.float32
          else lib.segment_jac_launch_f64)
    rc = fn(pk.KERNEL_MODELS.index("single"), p.data_ptr(), xs.data_ptr(),
            us.data_ptr(),
            *(o.data_ptr() for o in outs), R, sp, h, h * 0.5, h / 6.0,
            sum(1 << a for a in angle), threads,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise SystemExit(f"segment_jac launch failed: CUDA error {rc}")
    return outs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="DIR",
                    help="another checkout whose kernel 2 is timed too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_segment_jac: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = cs._card()
    print(f"card: {card}", flush=True)
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        ours = ex.submit(_build.build_library)
        other = ex.submit(_build_other, args.against) if args.against else None
        path, log = ours.result()
        libs = {"this": _build.open_library(path)}
        if other:
            libs["against"] = other.result()
    for line in log.splitlines():
        if "segment_jac" in line or "registers" in line or "stack" in line:
            print(f"[build] {line.strip()}", flush=True)

    B = cs.BATCH
    mpc = pt.make_mpc(pt.OptimizationParams(
        max_iterations=8, state_spacing=5, kkt_method="condensed"))
    h, angle = mpc.params.control_dt, mpc.model.angle_indices
    dp = pt.default_single_params(torch.float32, dev)
    x0 = torch.as_tensor(cs.make_x0s("single", B), dtype=torch.float32,
                         device=dev)
    cold = pt.MPCState(
        previous_solution=torch.zeros((B, mpc.spec.dim), device=dev),
        warm=torch.zeros((B,), dtype=torch.bool, device=dev))
    seg_cold = cs.segment_inputs_problem(
        *cs.setup_problem(mpc, cold, x0, torch.float64))
    res = pt.run_closed_loop_lanes(mpc, x0, dp, WARM_TICKS, fused=False)
    seg_warm = cs.segment_inputs_problem(*lanes._prepare(
        mpc, res.final_mpc_state, res.final_state, dp))
    cs.check_segment_jac("sweep: cold-start shooting problem", seg_cold, h,
                         card)
    cs.check_segment_jac(f"sweep: warm, after {WARM_TICKS} ticks of path 2",
                         seg_warm, h, card)
    problems = {"cold": tuple(t.float() for t in seg_cold),
                f"tick {WARM_TICKS}": tuple(t.float() for t in seg_warm),
                "f64 cold": seg_cold}

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    ref = {name: _launch(libs["this"], p, h, angle, pk.THREADS_PER_BLOCK)
           for name, p in problems.items()}
    R, sp = seg_cold[1].shape[1], seg_cold[2].shape[0]
    ok, rows, fns = True, [], {}
    for build, lib in libs.items():
        for threads in THREADS:
            row = dict(build=build, threads_per_block=threads)
            if build == "this":
                row.update(pk.kernel_occupancy(R, sp, threads))
            for name, p in problems.items():
                row[f"identical_{name}"] = same(
                    _launch(lib, p, h, angle, threads), ref[name])
                if build == "this":
                    ok &= row[f"identical_{name}"]
                if not name.startswith("f64"):
                    fns[len(rows), name] = (
                        lambda lib=lib, p=p, t=threads:
                        _launch(lib, p, h, angle, t))
            rows.append(row)
    row_clocks = cs.clocks()
    for (i, name), (med, least) in cs.device_ms(fns).items():
        rows[i][f"ms_{name}"], rows[i][f"least_ms_{name}"] = med, least
    for row in rows:
        print(f"[layout] {json.dumps(row)}  ({card}; SM clock, max, power, "
              f"temperature before: {row_clocks})", flush=True)
    if not ok:
        raise SystemExit("a block size changed the kernel's outputs")
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
