"""Driver ``lanes_fleet``: a fleet of independent plants, each with its own
MPC controller, run in episodes through the port's batched closed loop
(``run_closed_loop_lanes``), as ``sweep --layout auto`` and
``tools/batch_sweep.py --fused`` call it.

Each episode is one call of the entry over ``episode_ticks`` ticks, from
states (and, for a grid, dynamics parameters) drawn from ``(seed,
episode)`` and a cold warm start, synchronised at its end. The window
holds whole episodes: at least one, and another only while the time so far
plus the last episode's wall time stays within the run's seconds.

What a run keeps for the check: ``sample_per_episode`` plants of each
episode, drawn from the seed, with everything the entry returned for them.
The check follows every tick of those plants' episodes with the plain
reference (:func:`fleet_numbers`).
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from .. import compare, count, trace, traffic
from ..harness import merge


class Driver:
    """One run of a ``lanes_fleet`` cell. ``overrides`` (tests only)
    replace entries of the configuration, traffic and check files."""

    def __init__(self, cell, seed: int, device, overrides=None):
        overrides = overrides or {}
        self.seed = seed
        self.device = torch.device(device)
        self.config = merge(cell.config, overrides.get("config", {}))
        self.traffic = merge(cell.traffic, overrides.get("traffic", {}))
        self.spec = merge(cell.limits, overrides.get("check", {}))
        self.records = []

    # ----------------------------------------------------------- set-up
    def setup(self):
        import cartpole_tpu_torch as pt
        from cartpole_tpu_torch.mpc.lanes import run_closed_loop_lanes

        self._entry = run_closed_loop_lanes
        cfg = self.config
        self.dtype = getattr(torch, cfg["dtype"])
        self.model = pt.get_model(cfg["model"])
        self.mpc = pt.make_mpc(pt.OptimizationParams(**cfg["optimization"]),
                               self.model)
        self.batch = self.traffic["batch"]
        self.ticks = self.traffic["episode_ticks"]
        x0, dp, _, _ = self._inputs(-1)
        self._call(x0, dp, self.traffic["warm_ticks"])
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _inputs(self, index: int):
        """Episode ``index``'s states and dynamics parameters on the
        device (``-1``: the set-up's draw), and the host arrays."""
        x0s, grid = traffic.episode(self.traffic, self.model.state_dim,
                                    self.model.angle_indices, self.seed,
                                    index)
        fields = dict(self.config["dynamics"], **grid)
        dp = self.model.params_type(**{
            k: torch.as_tensor(np.asarray(v), dtype=self.dtype,
                               device=self.device)
            for k, v in fields.items()})
        x0 = torch.as_tensor(x0s, dtype=self.dtype, device=self.device)
        return x0, dp, x0s, grid

    def _call(self, x0, dp, ticks):
        return self._entry(self.mpc, x0, dp, ticks, fused=True)

    # ----------------------------------------------------------- window
    def window(self, seconds: float) -> dict:
        self._sync()
        t_start = time.perf_counter()
        episodes = attempted = failed = 0
        while True:
            x0, dp, x0s, grid = self._inputs(episodes)
            t0 = time.perf_counter()
            res = self._call(x0, dp, self.ticks)
            self._sync()
            wall = time.perf_counter() - t0
            n_failed, upright = self._tally(res)
            attempted += self.batch * self.ticks
            failed += n_failed
            self._keep(episodes, res, x0s, grid)
            del res
            print(f"episode {episodes}: {wall:.4f} s, failed {n_failed}, "
                  f"upright share at its end {upright:.6f}", flush=True)
            episodes += 1
            if time.perf_counter() - t_start + wall > seconds:
                break
        elapsed = time.perf_counter() - t_start
        solves = self.batch * self.ticks * episodes
        return {"metrics": {"solves_per_s": solves / elapsed},
                "attempted": attempted, "failed": failed}

    def _tally(self, res):
        """Failed solves (QP_INDEFINITE, MAX_LAMBDA, or a state that went
        non-finite) and the share of plants upright at the end: every link
        within 0.1 rad of upright."""
        codes = res.termination_states
        bad = (codes == 3) | (codes == 4)
        bad |= ~torch.isfinite(res.states).all(-1)
        ang = res.final_state[:, list(self.model.angle_indices)]
        off = torch.remainder(ang - math.pi / 2 + math.pi, 2 * math.pi)
        up = (torch.abs(off - math.pi) < 0.1).all(-1)
        return int(bad.sum()), float(up.double().mean())

    def _keep(self, episode, res, x0s, grid):
        idx = traffic.sample(self.batch, self.spec["sample_per_episode"],
                             self.seed, episode)
        it = torch.as_tensor(idx, device=self.device)

        def host(t, dtype=np.float64):
            return t.index_select(0, it).cpu().numpy().astype(dtype)

        self.records.append({
            "episode": episode,
            "x0": x0s[idx],
            "grid": {k: v[idx] for k, v in grid.items()},
            "states": host(res.states),
            "controls": host(res.controls),
            "pred": host(res.terminal_predictions),
            "codes": host(res.termination_states, np.int64),
            "iters": host(res.solver_iterations, np.int64),
            "final_state": host(res.final_state),
            "final_prev": host(res.final_mpc_state.previous_solution),
            "final_warm": host(res.final_mpc_state.warm, bool),
        })

    # ------------------------------------------------------------ trace
    def trace(self) -> dict:
        """The traced stretch: a synchronised 2-tick call of the entry
        (its start-up: tick 0 eager, tick 1's warm-up, capture and
        instantiation), then one more call of the entry at the cell's
        shapes in which ``trace_ticks`` of its own replays, after the
        first, run under the profiler; and the plain reference's count of
        the work."""
        from cartpole_tpu_torch.ops.fused import fused_solve

        x0, dp, _, _ = self._inputs(-1)
        self._sync()
        t0 = time.perf_counter()
        self._call(x0, dp, 2)
        self._sync()
        startup = time.perf_counter() - t0

        n = self.traffic["trace_ticks"]
        probe = trace.ReplayProbe(n, skip=1,
                                  count=lambda: fused_solve.launches)
        with probe:
            self._call(x0, dp, 2 + 1 + n + 1)
        self._sync()
        rec = probe.result()
        rec.update(driver="lanes_fleet", ticks=n, call_startup_s=startup)
        if rec.get("device_ops"):
            B = self.batch
            rec.update(kernel1_launches=rec["counted"],
                       kernel1_s=trace.device_seconds(
                           rec, "fused_iteration_kernel"),
                       kernel1_cost=count.kernel1_cost(self.config,
                                                       self.traffic, B),
                       tick_cost=count.tick_cost(self.config, self.traffic,
                                                 B))
            print(f"trace: {n} replays of the entry's graph, "
                  f"{rec['device_ops']} device operations, kernel 1 "
                  f"launched {rec['kernel1_launches']} times, "
                  f"{rec['kernel1_s']:.6f} s of it", file=sys.stderr)
        return rec

    # ------------------------------------------------------------ check
    def check(self) -> dict:
        """The compared numbers over the kept plants of up to
        ``episodes_checked`` episodes (the last, and others drawn from the
        seed), against the reference in float64, which follows every tick
        of their episodes: on the card as replays of one CUDA graph."""
        recs = self.records
        k = self.spec["episodes_checked"]
        if len(recs) > k:
            rest = traffic.sample(len(recs) - 1, k - 1, self.seed,
                                  traffic.PICK)
            recs = [recs[i] for i in rest] + [recs[-1]]
        rec = concat(recs)
        self.records = []
        return fleet_numbers(self.config, rec, self.spec["start_ticks"],
                             device=self.device)


def concat(recs: list) -> dict:
    """The kept plants of several episodes (or runs) as one batch."""
    out = {}
    for key in recs[0]:
        if key == "episode":
            continue
        if key == "grid":
            out[key] = {f: np.concatenate([r[key][f] for r in recs])
                        for f in recs[0][key]}
        else:
            out[key] = np.concatenate([r[key] for r in recs])
    return out


def split(chain: dict, sizes) -> list:
    """A reference chain over several batches of plants, cut back into one
    chain per batch of ``sizes`` plants."""
    ends = np.cumsum(sizes)[:-1]
    parts = {k: np.split(v, ends) for k, v in chain.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(len(sizes))]


def reference_parts(config: dict, n: int, grid: dict, dtype, device):
    """The reference's model, MPC and dynamics parameters for ``n``
    plants (fields ``(n,)`` where ``grid`` gives them)."""
    from ..reference.models import get_model
    from ..reference.mpc.config import OptimizationParams
    from ..reference.mpc.controller import MPC

    model = get_model(config["model"])
    mpc = MPC(OptimizationParams(**config["optimization"]), model)
    fields = dict(config["dynamics"], **grid)
    dp = model.params_type(**{
        k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
        for k, v in fields.items()})
    return model, mpc, dp


class Replay:
    """``fn`` captured once in a CUDA graph and replayed at every call:
    a call copies its arguments into the captured inputs, replays, and
    returns the captured outputs, which the next call overwrites. ``fn``
    first runs eagerly on ``args`` on a side stream, as capture requires,
    which builds what is made once (the reference's statics on the card,
    the libraries' handles); its outputs are ``warmup_outputs``."""

    def __init__(self, fn, args):
        self.inputs = tuple(a.clone() for a in args)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.warmup_outputs = fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = fn(*self.inputs)

    def __call__(self, *args):
        for dst, src in zip(self.inputs, args):
            dst.copy_(src)
        self.graph.replay()
        return self.outputs


def reference_chain(config: dict, states, grid: dict, dtype, device,
                    closed: bool = False) -> dict:
    """The reference's lanes tick over every tick of ``states`` (``(n, T,
    sd)`` host array) from a cold warm start, each tick warm-started from
    the reference's own last solution. By default tick ``t`` solves at the
    program's state ``states[:, t]``; ``closed`` starts at ``states[:, 0]``
    and steps its own plant (the control, put in the program's place). On
    the card the tick after the first is a replay of one CUDA graph
    (:class:`Replay`). Returns host arrays ``(n, T, ...)``: the state
    solved at, the plant step from it with the reference's control,
    ``u0``, the terminal prediction, code, iterations; and the final
    previous solution and warm flag."""
    from ..reference.mpc.lanes import tick_fn_lanes

    n, T, sd = states.shape
    model, mpc, dp = reference_parts(config, n, grid, dtype, device)
    tick = tick_fn_lanes(mpc, dp, torch.zeros((n,), dtype=dtype,
                                              device=device))
    xs = torch.as_tensor(np.array(states[:, :T if not closed else 1]),
                         dtype=dtype, device=device)
    x = xs[:, 0].T.contiguous()
    prev = torch.zeros((n, mpc.spec.dim), dtype=dtype, device=device)
    warm = torch.zeros((n,), dtype=torch.bool, device=device)
    step = tick
    cols = {k: [] for k in ("x_next", "u", "pred", "codes", "iters")}
    for t in range(T):
        if not closed:
            x = xs[:, t].T.contiguous()
        if t == 0 and torch.device(device).type == "cuda":
            step = Replay(tick, (x, prev, warm))
            out = step.warmup_outputs
        else:
            out = step(x, prev, warm)
        for key, i in (("x_next", 0), ("u", 4), ("pred", 5), ("codes", 6),
                       ("iters", 8)):
            cols[key].append(out[i].clone())
        x, prev, warm = out[0], out[1], out[2]

    def host(t, dtype=np.float64):
        return t.cpu().numpy().astype(dtype)

    res = {
        "x_next": host(torch.stack(cols["x_next"]).permute(2, 0, 1)),
        "u": host(torch.stack(cols["u"], 1)),
        "pred": host(torch.stack(cols["pred"], 1)),
        "codes": host(torch.stack(cols["codes"], 1), np.int64),
        "iters": host(torch.stack(cols["iters"], 1), np.int64),
        "final_prev": host(prev),
        "final_warm": host(warm, bool),
    }
    del step
    res["x_in"] = (np.asarray(states, np.float64) if not closed else
                   np.concatenate([np.asarray(states[:, :1], np.float64),
                                   res["x_next"][:, :-1]], 1))
    return res


def as_record(chain: dict, x0s, grid: dict) -> dict:
    """A reference chain in the layout of a kept episode, so that it can
    stand in the program's place (the control)."""
    return {"x0": x0s, "grid": grid, "states": chain["x_in"],
            "controls": chain["u"], "pred": chain["pred"],
            "codes": chain["codes"], "iters": chain["iters"],
            "final_state": chain["x_next"][:, -1],
            "final_prev": chain["final_prev"],
            "final_warm": chain["final_warm"]}


def fleet_numbers(config: dict, rec: dict, start_ticks: int,
                  chain: dict | None = None, device="cpu") -> dict:
    """The compared numbers of kept plants ``rec``. The reference solves
    again at the program's plant state of every tick, warm-started from
    its own solutions (``chain``, :func:`reference_chain` on ``device``,
    if not given).

    * The first ``start_ticks`` ticks (an eager tick, the capture's
      warm-up, then replays), which start cold on both sides: their
      controls (``u_gap``), codes and iterations (``path_miss``), terminal
      predictions and one plant step with the reference's control
      (``x_gap.chain``, ``x_gap.pred``).
    * Every tick of the episode: for each plant the median over its ticks
      of the control's gap, and the 90th percentile and largest of those
      over the plants (``u_gap.episode``); ``path_miss.episode``. A
      median per plant, because f32 and f64 warm starts part ways on a few
      ticks of a swing-up and meet again (``PERF.md``).
    * Every later tick's plant step is taken again from the program's
      state and control (``x_gap.plant``).
    * The last tick's terminal prediction is rolled out again from the
      solution the entry returned (``x_gap.final``).
    """
    from ..reference.ops.lanes import rollout_rows
    from ..reference.mpc.lanes import simulator_step_lanes

    dtype = torch.float64
    states = rec["states"]
    n, T, sd = states.shape
    C = min(start_ticks, T)
    x_next = np.concatenate([states[:, 1:], rec["final_state"][:, None]], 1)
    if chain is None:
        chain = reference_chain(config, states, rec["grid"], dtype, device)
    model, mpc, dp = reference_parts(config, n, rec["grid"], dtype, "cpu")
    angle = model.angle_indices
    parts = {
        "chain": compare.state_gap(x_next[:, :C], chain["x_next"][:, :C],
                                   angle),
        "pred": compare.state_gap(rec["pred"][:, :C], chain["pred"][:, :C],
                                  angle),
    }
    u = compare.u_gaps(rec["controls"][:, :C], chain["u"][:, :C])
    miss = compare.path_miss(rec["codes"][:, :C], chain["codes"][:, :C],
                             rec["iters"][:, :C], chain["iters"][:, :C])

    dt = config["optimization"]["control_dt"]
    if T > C:
        m = T - C
        _, _, dp_rep = reference_parts(
            config, n * m, {k: np.repeat(v, m) for k, v in
                            rec["grid"].items()}, dtype, "cpu")
        xs = torch.as_tensor(states[:, C:].reshape(n * m, sd),
                             dtype=dtype).T.contiguous()
        us = torch.as_tensor(rec["controls"][:, C:].reshape(n * m),
                             dtype=dtype)
        stepped = simulator_step_lanes(dp_rep, xs, dt, us, model=model)
        parts["plant"] = compare.state_gap(
            x_next[:, C:].reshape(n * m, sd), stepped.T.numpy(), angle)

    warm = rec["final_warm"]
    if warm.any():
        _, _, dp_w = reference_parts(
            config, int(warm.sum()),
            {k: v[warm] for k, v in rec["grid"].items()}, dtype, "cpu")
        u_sol = torch.as_tensor(rec["final_prev"][warm, mpc.spec.u_start:],
                                dtype=dtype).T.contiguous()
        x_last = torch.as_tensor(states[warm, T - 1], dtype=dtype).T
        final = rollout_rows(
            lambda xr, u_: model.dynamics_core(dp_w, xr, u_),
            tuple(x_last), u_sol, dt, angle)
        parts["final"] = compare.state_gap(
            rec["pred"][warm, T - 1], torch.stack(final).T.numpy(), angle)
    out = compare.summary(u, parts, miss)
    every = compare.u_gaps(rec["controls"], chain["u"])
    per_plant = np.median(every, 1)
    out["u_gap.episode.p90"] = float(np.percentile(per_plant, 90))
    out["u_gap.episode.max"] = float(np.max(per_plant))
    for q in (50, 90, 99):
        out[f"u_gap.every.p{q}"] = float(np.percentile(every, q))
    out["path_miss.episode"] = compare.path_miss(
        rec["codes"], chain["codes"], rec["iters"], chain["iters"])
    return out
