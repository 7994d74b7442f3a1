"""Command-line interface: solve / closed-loop / sweep / interactive / web /
replay drivers (counterpart of ``cartpole_tpu/cli.py``).

The same flags and printed JSON keys as the JAX package's CLI, on the card:
the tensors live on the CUDA device unless ``--cpu`` asks for the CPU, and
without a CUDA device and without ``--cpu`` the CLI exits non-zero. The
default precision is f64, ``--f32`` the fast path. All configs round-trip
JSON with the reference's field names (``wasm.cc:23-28``).

Usage::

    python -m cartpole_tpu_torch solve --params '{"state_spacing": 5}'
    python -m cartpole_tpu_torch closed-loop --steps 250 --log-json log.json
    python -m cartpole_tpu_torch sweep --batch 4096 --steps 100 --f32
    torchrun --nproc_per_node 2 -m cartpole_tpu_torch sweep --batch 4096
    python -m cartpole_tpu_torch interactive
    python -m cartpole_tpu_torch web --port 8080
    python -m cartpole_tpu_torch replay log.json --charts charts.png

``sweep`` runs through ``parallel/``: under ``torchrun`` each rank takes its
slice of the batch, the diagnostics are all-reduced, and rank 0 prints.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Optional, Sequence

__all__ = ["main"]

_NO_CUDA = ("no CUDA device: the port runs on the card; pass --cpu to run "
            "on the CPU")


def _add_common(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--model", choices=("single", "double", "triple"),
                    default="single")
    ap.add_argument("--params", default="{}",
                    help="OptimizationParams overrides as JSON")
    ap.add_argument("--dynamics", default="{}",
                    help="dynamics parameter overrides as JSON")
    ap.add_argument("--x0", default=None,
                    help="initial state as JSON list (default: hanging down)")
    ap.add_argument("--set-point", type=float, default=0.0)
    ap.add_argument("--f32", action="store_true",
                    help="f32 fast path (default: f64 parity precision)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")


def _device(args):
    import torch

    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit(_NO_CUDA)
    return torch.device("cuda")


def _setup(args, device=None):
    """``(mpc, dynamics_params, x0, dtype, device)`` from the common
    flags."""
    import torch

    from . import OptimizationParams, get_model, make_mpc

    device = device if device is not None else _device(args)
    dtype = torch.float32 if args.f32 else torch.float64
    model = get_model(args.model)
    if args.model in ("double", "triple") \
            and "window_length" not in json.loads(args.params):
        # The 0.4 s default window leaves the double/triple pole on the
        # edge of its region of attraction; applied to every subcommand.
        args.params = json.dumps(
            {**json.loads(args.params), "window_length": 60})
    params = OptimizationParams.from_json(args.params)
    # from_json validates field names (a typo'd --dynamics key gets the
    # designed error listing the known fields, not a raw TypeError).
    dyn_defaults = json.loads(model.params_type().to_json())
    dynamics_params = model.params_type.from_json(json.dumps(
        {**dyn_defaults, **json.loads(args.dynamics)})).to(dtype, device)
    if args.x0 is not None:
        x0 = torch.tensor(json.loads(args.x0), dtype=dtype, device=device)
    else:
        down = [0.0] * model.state_dim
        for a in model.angle_indices:
            down[a] = -math.pi / 2
        x0 = torch.tensor(down, dtype=dtype, device=device)
    return make_mpc(params, model), dynamics_params, x0, dtype, device


def _termination_summary(term) -> dict:
    """The histogram and failure count of a host array of codes."""
    from .ops.solver import NLSTerminationState, termination_state_name

    return {
        "termination_histogram": {
            termination_state_name(k): int((term == k).sum())
            for k in range(5) if int((term == k).sum())
        },
        "n_failed": int(((term == NLSTerminationState.QP_INDEFINITE)
                         | (term == NLSTerminationState.MAX_LAMBDA)).sum()),
    }


def _cmd_solve(args) -> int:
    from .utils import solve_log_entry, solver_summary

    mpc, dynamics_params, x0, dtype, device = _setup(args)
    outputs, _ = mpc.step(mpc.init_state(dtype, device), x0, dynamics_params,
                          args.set_point)
    print(solver_summary(outputs.solver))
    print(f"device: {outputs.u.device}, dtype: {outputs.u.dtype}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(solve_log_entry(outputs), f)
        print(f"wrote {args.json}")
    return 0


def _cmd_closed_loop(args) -> int:
    from . import run_closed_loop, run_scheduled_closed_loop
    from .ops.solver import termination_state_name

    mpc, dynamics_params, x0, _, _ = _setup(args)
    if args.schedule:
        # Time-varying solver-parameter schedule (mpc/schedule.py):
        # '[[50, {"u_derivative_cost_weight": 0.8}], [200, null]]' runs
        # 50 shaped ticks then 200 base ticks, warm start chained.
        schedule = [(int(ticks), overrides)
                    for ticks, overrides in json.loads(args.schedule)]
        args.steps = sum(t for t, _ in schedule)

        def run(x):
            return run_scheduled_closed_loop(mpc, x, dynamics_params,
                                             schedule, args.set_point)
    else:
        def run(x):
            return run_closed_loop(mpc, x, dynamics_params, args.steps,
                                   args.set_point)
    t0 = time.perf_counter()
    res = run(x0)
    # The host copy synchronizes the card.
    term = res.termination_states.cpu().numpy()
    wall = time.perf_counter() - t0
    xf = res.final_state.cpu().numpy()
    summary = {
        "steps": args.steps,
        "wall_s": round(wall, 3),
        "final_state": [float(v) for v in xf],
        **_termination_summary(term),
        "max_constraint_violation_after_warmup": float(
            res.constraint_violations[min(21, args.steps - 1):].max()),
    }
    print(json.dumps(summary, indent=2))

    if args.log_json:
        states = res.states.cpu().numpy()
        controls = res.controls.cpu().numpy()
        entries = [
            {
                "state": [float(v) for v in states[t]],
                "u": float(controls[t]),
                "termination_state": termination_state_name(int(term[t])),
            }
            for t in range(args.steps)
        ]
        with open(args.log_json, "w") as f:
            json.dump(entries, f)
        print(f"wrote {args.log_json}")

    if args.plot:
        from .analysis import plot_closed_loop

        plot_closed_loop(res, control_dt=mpc.params.control_dt,
                         save_to=args.plot)
        print(f"wrote {args.plot}")
    return 0


def _interactive_loop(args):
    """The ``InteractiveLoop`` of the common flags, from ``x0`` at the set
    point."""
    from .interactive import InteractiveLoop

    mpc, dynamics_params, x0, dtype, device = _setup(args)
    loop = InteractiveLoop(params=mpc.params, dynamics_params=dynamics_params,
                           dtype=dtype, model=mpc.model, device=device,
                           render=False)
    loop.x = x0
    loop.set_point = args.set_point
    return loop


def _cmd_interactive(args) -> int:
    loop = _interactive_loop(args)
    if not sys.stdin.isatty():
        print("no tty: running 200 scripted ticks with a pole poke at t=1s",
              file=sys.stderr)
        cmds = [None] * 100 + ["p"] + [None] * 99
        loop.run(max_ticks=200, realtime=False, commands=cmds)
        print(f"final state: {[round(float(v), 4) for v in loop.x]}")
    else:
        loop.render = True
        loop.run()
    if args.log_json:
        loop.log.save(args.log_json)
        print(f"wrote {args.log_json}")
    return 0


def _cmd_web(args) -> int:
    from .web import serve

    serve(args.host, args.port, loop=_interactive_loop(args))
    return 0


def pick_layout(layout: str, mpc, x0s, dynamics_params) -> str:
    """``"auto"`` -> ``"lanes-fused"`` where the condensed path applies and
    the port's ``ops/fused.py::fused_supported`` holds for the tick-0
    problem of ``x0s`` (the rank's slice), else ``"vmap"``; any other
    layout unchanged."""
    if layout != "auto":
        return layout
    if mpc.params.kkt_method != "condensed":
        return "vmap"
    import torch

    from .mpc.controller import MPCState
    from .mpc.lanes import _prepare
    from .ops.fused import fused_supported

    B = x0s.shape[0]
    cold = MPCState(
        torch.zeros((B, mpc.spec.dim), dtype=x0s.dtype, device=x0s.device),
        torch.zeros((B,), dtype=torch.bool, device=x0s.device))
    problem, _ = _prepare(mpc, cold, x0s, dynamics_params)
    return "lanes-fused" if fused_supported(problem, mpc.nls_config) \
        else "vmap"


def sweep_x0s(model, x0, n: int, seed: int):
    """The sweep's ``n`` initial states: ``x0`` with the cart position and
    every link angle perturbed uniformly by up to 0.3 (numpy, seed
    ``seed``), as the reference's sweep draws them."""
    import numpy as np

    rng = np.random.RandomState(seed)
    x0s = np.tile(np.asarray(x0), (n, 1))
    x0s[:, 0] += rng.uniform(-0.3, 0.3, n)
    for a in model.angle_indices:
        x0s[:, a] += rng.uniform(-0.3, 0.3, n)
    return x0s


def _cmd_sweep(args) -> int:
    import torch
    import torch.distributed as dist

    from .parallel import (gather_scenarios, initialize_distributed,
                           make_scenario_mesh, make_sharded_closed_loop,
                           shard_scenarios)

    _device(args)  # exits without a card unless --cpu
    initialize_distributed()
    mesh = make_scenario_mesh(device="cpu" if args.cpu else None)
    mpc, dynamics_params, x0, dtype, _ = _setup(args, mesh.device)
    n = args.batch
    x0s, sps = shard_scenarios(
        (torch.as_tensor(sweep_x0s(mpc.model, x0.cpu().numpy(), n,
                                   args.seed), dtype=dtype),
         torch.full((n,), args.set_point, dtype=dtype)), mesh)
    layout = pick_layout(args.layout, mpc, x0s, dynamics_params)
    run = make_sharded_closed_loop(mpc, mesh, num_steps=args.steps,
                                   layout=layout)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        if mesh.group is not None:
            dist.barrier(mesh.group)

    sync()
    t0 = time.perf_counter()
    result, diag = run(x0s, dynamics_params, sps)
    sync()
    wall = time.perf_counter() - t0
    gathered = gather_scenarios(
        {"controls": result.controls, "final_state": result.final_state,
         "termination_states": result.termination_states}, mesh)
    xf = gathered["final_state"].cpu()
    # Upright = EVERY pole angle near pi/2 (a double pole with the second
    # link hanging is not upright).
    upright = torch.all(torch.abs(xf[:, list(mpc.model.angle_indices)]
                                  - math.pi / 2) < 1e-2, dim=1)
    summary = {
        "batch": n,
        "steps": args.steps,
        "layout": layout,
        "devices": mesh.world_size,
        "wall_s": round(wall, 3),
        "solves_per_s": round(n * args.steps / wall, 1),
        "n_failed_solves": int(diag.n_failed),
        "mean_iterations": round(float(diag.mean_iterations), 3),
        "max_violation": float(diag.max_violation),
        "fraction_upright": float(upright.double().mean()),
    }
    if mesh.rank == 0:
        if args.results:
            from .utils import save_state

            save_state(args.results, {
                **gathered, "diagnostics": diag._asdict(),
                "summary": {k: v for k, v in summary.items()
                            if isinstance(v, (int, float))}})
        print(json.dumps(summary, indent=2))
    return 0


def _cmd_replay(args) -> int:
    import numpy as np

    from .utils import load_log, replay_log

    rep = replay_log(load_log(args.log))
    summary = {
        "ticks": int(rep.states.shape[0]),
        "state_dim": int(rep.states.shape[1]),
        "final_state": [float(v) for v in rep.states[-1]],
        "has_predictions": rep.predicted_states is not None,
        **_termination_summary(rep.termination_states),
        "max_abs_u": float(np.abs(rep.controls).max()),
    }
    print(json.dumps(summary, indent=2))

    n_links = (rep.states.shape[1] - 2) // 2
    lengths = tuple(args.length for _ in range(n_links))
    if args.charts:
        from .viz import strip_charts

        strip_charts(rep, control_dt=args.dt, save_to=args.charts)
        print(f"wrote {args.charts}")
    if args.gif:
        from .viz import animate_closed_loop

        animate_closed_loop(
            rep, lengths=lengths, control_dt=args.dt, save_to=args.gif,
            predicted_states=rep.predicted_states)
        print(f"wrote {args.gif}")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="cartpole_tpu_torch",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="command", required=True)

    ap_solve = sub.add_parser("solve", help="one MPC solve + solver summary")
    _add_common(ap_solve)
    ap_solve.add_argument("--json", default=None, help="write solve log JSON")
    ap_solve.set_defaults(fn=_cmd_solve)

    ap_cl = sub.add_parser("closed-loop", help="receding-horizon run")
    _add_common(ap_cl)
    ap_cl.add_argument("--steps", type=int, default=250)
    ap_cl.add_argument("--log-json", default=None)
    ap_cl.add_argument("--plot", default=None, help="save trajectory plot PNG")
    ap_cl.add_argument(
        "--schedule", default=None,
        help="time-varying solver-parameter schedule as JSON "
        "[[ticks, {overrides}|null], ...] (run_scheduled_closed_loop; "
        "overrides are OptimizationParams fields; overrides --steps)")
    ap_cl.set_defaults(fn=_cmd_closed_loop)

    ap_sw = sub.add_parser("sweep", help="sharded batched scenario sweep")
    _add_common(ap_sw)
    ap_sw.add_argument("--batch", type=int, default=256)
    ap_sw.add_argument("--steps", type=int, default=100)
    ap_sw.add_argument("--seed", type=int, default=0)
    ap_sw.add_argument(
        "--layout", default="auto",
        choices=("auto", "vmap", "lanes", "lanes-fused"),
        help="per-rank batching layout: auto picks lanes-fused (kernel 1, "
        "one launch a solve) where kkt_method is condensed and the fused "
        "kernel covers the problem (ops/fused.py::fused_supported), else "
        "vmap (the per-instance path); lanes runs kernel 2 for the "
        "linearization. lanes and lanes-fused need kkt_method=condensed")
    ap_sw.add_argument(
        "--results", default=None,
        help="write every scenario's controls, termination codes and final "
        "state (gathered from every rank), the diagnostics and the summary "
        "to this .npz (utils.save_state)")
    ap_sw.set_defaults(fn=_cmd_sweep)

    ap_int = sub.add_parser(
        "interactive",
        help="live terminal closed loop: poke the plant, tweak params "
        "(the web-demo capability; keys: b/B/p/P poke, c toggle "
        "controller, 1-4 mass/length, t cost<->equality, r reset, q "
        "quit); with no tty, 200 scripted ticks with a pole poke at tick "
        "100. On the card every tick after a rebuild's first replays a "
        "CUDA graph")
    _add_common(ap_int)
    ap_int.add_argument(
        "--log-json", default=None,
        help="write the solve log (the web page's 'Save log' payload, one "
        "entry per solved tick) here at exit")
    ap_int.set_defaults(fn=_cmd_interactive)

    ap_web = sub.add_parser(
        "web",
        help="browser demo: canvas renderer + mouse pokes + live param "
        "sliders over a local HTTP server (the reference web app's "
        "capability, solver server-side on the card)")
    _add_common(ap_web)
    ap_web.add_argument("--host", default="127.0.0.1")
    ap_web.add_argument("--port", type=int, default=8080)
    ap_web.set_defaults(fn=_cmd_web)

    ap_rp = sub.add_parser(
        "replay",
        help="re-render a saved log.json (web 'Save log' or closed-loop "
        "--log-json) as summary/strip charts/animation; no solver run")
    ap_rp.add_argument("log", help="path to the saved log JSON")
    ap_rp.add_argument("--charts", default=None, help="save strip-chart PNG")
    ap_rp.add_argument("--gif", default=None,
                       help="save animation GIF (with prediction ghosts "
                       "when the log carries them)")
    ap_rp.add_argument("--dt", type=float, default=0.01,
                       help="tick duration for time axes (control_dt)")
    ap_rp.add_argument("--length", type=float, default=0.25,
                       help="per-link length for rendering")
    ap_rp.set_defaults(fn=_cmd_replay)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
