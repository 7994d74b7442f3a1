"""Single cart-pole swing-up, end to end, with plots and logs (the port of
``examples/swingup.py``).

Configure, run a receding-horizon swing-up from the hanging pole
(``run_closed_loop``: f64, spacing 5, 10 GN iterations; on the card every
tick after the first replays a CUDA-graph capture of the tick), print the
final state and the solver summary of one more solve from it, and write
the JSON solve log of that solve (``log.json``), the trajectory plots
(``trajectory.png``, ``strips.png``) and, with ``--gif``, an animation
(``swingup.gif``). The plots need matplotlib; without it they are skipped
and the run says so.

Usage, from the repository root:
    python3 -m cartpole_tpu_torch.tools.swingup [--steps 250]
        [--out-dir DIR] [--gif] [--device cpu]
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile

import torch

from .. import (OptimizationParams, default_single_params, make_mpc,
                run_closed_loop)
from ..utils import SolveLog, solver_summary

#: The example's controller: spacing 5, 10 GN iterations.
BASE_PARAMS = dict(state_spacing=5, max_iterations=10)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--out-dir",
                    default=os.path.join(tempfile.gettempdir(), "swingup"))
    ap.add_argument("--gif", action="store_true", help="render an animation")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the swing-up and write its files; returns ``(result, outputs)``:
    the closed loop's ``ClosedLoopResult`` and the ``MPCOutputs`` of the
    solve from its final state."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    os.makedirs(args.out_dir, exist_ok=True)

    mpc = make_mpc(OptimizationParams(
        **BASE_PARAMS))
    dyn = default_single_params(torch.float64, device=device)
    x0 = torch.tensor([0.0, -math.pi / 2, 0.0, 0.0], dtype=torch.float64,
                      device=device)  # hanging down

    print(f"running {args.steps} receding-horizon ticks...", flush=True)
    res = run_closed_loop(mpc, x0, dyn, args.steps)
    xf = res.final_state.cpu().tolist()
    print(f"final state: b_x={xf[0]:+.4f}  th={xf[1]:+.5f} "
          f"(target {math.pi / 2:.5f})  b_v={xf[2]:+.1e}  "
          f"th_v={xf[3]:+.1e}")

    # One more solve from the final state for a full diagnostics record.
    outputs, _ = mpc.step(res.final_mpc_state, res.final_state, dyn)
    print(solver_summary(outputs.solver))

    log = SolveLog()
    log.append(outputs)
    log.save(os.path.join(args.out_dir, "log.json"))
    written = ["log.json"]
    try:
        from ..analysis import plot_closed_loop
        from ..viz import strip_charts

        plot_closed_loop(res, save_to=os.path.join(args.out_dir,
                                                   "trajectory.png"))
        strip_charts(res, save_to=os.path.join(args.out_dir, "strips.png"))
        written += ["trajectory.png", "strips.png"]
        if args.gif:
            from ..viz import animate_closed_loop

            animate_closed_loop(res, stride=4, save_to=os.path.join(
                args.out_dir, "swingup.gif"))
            written.append("swingup.gif")
    except ImportError as e:
        print(f"plots skipped: {e}")
    print(f"wrote {args.out_dir}/{', '.join(written)}")
    return res, outputs


if __name__ == "__main__":
    main()
