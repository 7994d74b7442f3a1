"""The per-instance closed loop (counterpart of
``cartpole_tpu/mpc/closed_loop.py``): MPC solve, apply ``u[0]`` to the
1 kHz plant, carry the warm start, tick after tick. The batched loop in the
lanes layout is ``mpc/lanes.py::run_closed_loop_lanes``; this one batches
with ``torch.func.vmap``, as the reference's callers use ``jax.vmap``::

    torch.func.vmap(lambda x: run_closed_loop(mpc, x, dp, T))(x0s)

The loop runs on ``x0``'s device and stacks each tick's results there:
nothing is read back to the host between ticks. On the card a tick is
some 97k launches of tiny kernels, which the host launches far slower than
the card runs them (1.2-2.0 s a tick against ~0.12 s of device work on an
H100; PERF.md), so there the loop captures one tick in a CUDA graph and
replays it (:class:`CUDAGraphTick`): the same kernels on the same inputs,
launched at once.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..utils.tracing import capture_marks, trace_scope
from .controller import MPC, MPCState
from .simulator import simulator_step

__all__ = ["ClosedLoopResult", "run_closed_loop", "closed_loop_step",
           "CUDAGraphTick", "launch_counts"]


class ClosedLoopResult(NamedTuple):
    """One instance's run; a batch (``vmap``, or the lanes loop) puts its
    axis first."""

    final_state: Any  #: (state_dim,) plant state after the last step.
    final_mpc_state: MPCState
    states: Any  #: (num_steps, state_dim) plant state at each tick.
    controls: Any  #: (num_steps,) applied u[0] at each tick.
    terminal_predictions: Any  #: (num_steps, state_dim) terminal state.
    termination_states: Any  #: (num_steps,) solver termination codes.
    constraint_violations: Any  #: (num_steps,) final ||c||_inf per solve.
    solver_iterations: Any  #: (num_steps,) iterations used per solve.


def closed_loop_step(mpc: MPC, carry, dynamics_params, set_point,
                     auto_reset: bool = True, f_base=None, f_mass=None):
    """One control tick: solve, apply ``u[0]`` to the plant for
    ``control_dt``. ``carry`` is ``(x, mpc_state)``; returns ``((x_next,
    mpc_state), (outputs, u0))``.

    With ``auto_reset`` a failed solve (QP_INDEFINITE, MAX_LAMBDA or a
    non-finite solution) discards the warm start, so the next tick starts
    cold, and applies ``u = 0`` for the tick. ``f_base``/``f_mass`` are
    external forces on the plant only, which the planner never sees."""
    x, mpc_state = carry
    outputs, mpc_state = mpc.step(mpc_state, x, dynamics_params, set_point)
    u0 = outputs.u[0]
    if auto_reset:
        failed = mpc.failure_mask(outputs)
        mpc_state = mpc.reset_where(mpc_state, failed)
        u0 = torch.where(failed, torch.zeros_like(u0), u0)
    x_next = simulator_step(dynamics_params, x, mpc.params.control_dt, u0,
                            f_base, f_mass, model=mpc.model)
    return (x_next, mpc_state), (outputs, u0)


def tick_fn(mpc: MPC, dynamics_params, set_point, auto_reset: bool = True):
    """:func:`closed_loop_step` as a function of tensors only, ``(x,
    previous_solution, warm[, disturbance (2, 2)]) -> (x_next,
    previous_solution, warm, u0, terminal prediction, termination code,
    constraint violation, iterations)``: the unit :func:`run_closed_loop`
    repeats and :class:`CUDAGraphTick` captures."""

    def tick(x, previous_solution, warm, dist=None):
        (x_next, st), (out, u0) = closed_loop_step(
            mpc, (x, MPCState(previous_solution, warm)), dynamics_params,
            set_point, auto_reset, None if dist is None else dist[0],
            None if dist is None else dist[1])
        return (x_next, st.previous_solution, st.warm, u0,
                out.predicted_states[-1], out.solver.termination_state,
                out.solver.constraint_violation, out.solver.n_iterations)

    return tick


#: One warm-up stream per device, made on first use and kept: the solver
#: libraries keep a workspace for each stream they run on (~33.5 MB on an
#: H100 80GB HBM3 at 700.00 W, PERF.md) and never free it, so a new stream
#: per capture would grow the card's memory with every capture.
_WARMUP_STREAMS: dict[int, torch.cuda.Stream] = {}


def _warmup_stream() -> torch.cuda.Stream:
    dev = torch.cuda.current_device()
    if dev not in _WARMUP_STREAMS:
        _WARMUP_STREAMS[dev] = torch.cuda.Stream(dev)
    return _WARMUP_STREAMS[dev]


def _counted_kernels():
    """The kernel wrappers whose ``launches`` attribute counts their
    kernel's launches (imported here: ``ops/fused.py`` imports this
    package)."""
    from ..ops.fused import fused_solve
    from ..ops.pallas_kernels import segment_jac_batch_last

    return fused_solve, segment_jac_batch_last


def launch_counts() -> tuple:
    """Each counted kernel's ``launches``, in :func:`_counted_kernels`'s
    order."""
    return tuple(k.launches for k in _counted_kernels())


def add_launches(delta, sign: int = 1) -> None:
    """Add ``sign * delta`` to each counted kernel's ``launches``."""
    for k, d in zip(_counted_kernels(), delta):
        k.launches += sign * d


class CUDAGraphTick:
    """``fn`` captured once in a CUDA graph on the current stream, and
    replayed for every call: each call copies its arguments into the
    captured inputs, replays, and returns clones of the captured outputs.

    ``fn`` must take and return tensors on the card, read nothing back to
    the host and keep the shapes of ``example_args``. Before the capture
    ``fn`` runs once eagerly on ``example_args`` on the device's one
    warm-up stream, as capture requires, which makes what is made once,
    such as the problem's statics on the device and the solver libraries'
    handles; its outputs are kept as ``warmup_outputs`` (an output that is
    a view of an argument views ``example_args``, not the graph's inputs,
    which every replay overwrites).
    A capture that fails raises. The graph and its memory live as long as
    this object.

    The kernel wrappers count a launch when they enqueue it, which during
    the capture runs nothing on the device: the counts the capture adds
    (``launches``) are taken back, and added again at every replay.

    With tracing on (``utils/tracing.py``) the warm-up, the capture (with
    the bytes it reserved for the graph's private pool) and the
    instantiation are spans ``graph.warmup``, ``graph.capture`` and
    ``graph.instantiate``, and each span that ``fn`` opens under the
    capture is marked in the graph by timing events: :meth:`phase_ms`
    reads them after a replay."""

    def __init__(self, fn, example_args):
        self.inputs = tuple(a.clone() for a in example_args)
        with trace_scope("graph.warmup"):
            self.warmup_outputs = self._warm_up(fn, example_args)
        before = launch_counts()
        with trace_scope("graph.capture") as span, capture_marks() as marks:
            span["pool_bytes"] = self._capture(fn)
        self.launches = tuple(
            a - b for a, b in zip(launch_counts(), before))
        add_launches(self.launches, -1)
        self.marks = marks
        with trace_scope("graph.instantiate"):
            self.graph.instantiate()

    def _warm_up(self, fn, args):
        side = _warmup_stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            outputs = fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        return outputs

    def _capture(self, fn) -> int:
        """Captures ``fn`` on the inputs into ``graph`` (instantiated
        after) and sets ``outputs``; returns the bytes the capture reserved
        for the graph's private pool."""
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(self.graph):
            reserved = torch.cuda.memory_reserved()
            self.outputs = fn(*self.inputs)
            return torch.cuda.memory_reserved() - reserved

    def phase_ms(self) -> dict:
        """Device milliseconds of each span marked at the capture (the
        lanes tick's ``tick.*`` phases), name by name, in the last replay,
        read from the timing events that replay recorded: it waits for
        them, so call it after a replay. Empty if tracing was off at the
        capture. This is the reading an operator of a fleet would log: it
        needs no profiler, so it times a replay as an unprofiled run runs
        it."""
        out = {}
        for name, start, end in self.marks:
            end.synchronize()
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out

    def __call__(self, *args):
        for dst, src in zip(self.inputs, args):
            dst.copy_(src)
        self.graph.replay()
        add_launches(self.launches)
        return tuple(o.clone() for o in self.outputs)


def run_closed_loop(mpc: MPC, x0, dynamics_params, num_steps: int,
                    set_point=0.0, mpc_state: MPCState | None = None,
                    auto_reset: bool = True,
                    disturbances=None) -> ClosedLoopResult:
    """Run ``num_steps`` receding-horizon ticks from ``x0`` ``(sd,)``.

    ``disturbances``: optional ``(num_steps, 2, 2)`` external plant forces
    per tick, ``[:, 0]`` at the base and ``[:, 1]`` at the first link mass,
    each ``(fx, fy)``; the planner never sees them. On the card every tick
    after the first is a replay of one CUDA-graph capture of the tick
    (module docstring).
    """
    dtype, device = x0.dtype, x0.device
    if mpc_state is None:
        mpc_state = mpc.init_state(dtype, device)
    if isinstance(set_point, torch.Tensor):
        set_point = set_point.to(dtype)
    if disturbances is not None:
        disturbances = torch.as_tensor(disturbances, dtype=dtype,
                                       device=device)
        if tuple(disturbances.shape) != (num_steps, 2, 2):
            raise ValueError(
                f"disturbances must be (num_steps, 2, 2) = "
                f"{(num_steps, 2, 2)}, got {tuple(disturbances.shape)}")

    def dist(t):
        return () if disturbances is None else (disturbances[t],)

    tick = tick_fn(mpc, dynamics_params, set_point, auto_reset)
    carry = (x0, mpc_state.previous_solution, mpc_state.warm)
    ticks = []
    for t in range(num_steps):
        if t == 1 and x0.is_cuda:
            # Captured from the second tick's inputs: the first tick's may
            # be unbatched under vmap (a cold state), the later ones not.
            tick = CUDAGraphTick(tick, carry + dist(t))
        out = tick(*carry, *dist(t))
        ticks.append((carry[0],) + out[3:])
        carry = out[:3]
    states, controls, term_pred, term_codes, violations, iters = (
        torch.stack(col) for col in zip(*ticks))
    return ClosedLoopResult(
        final_state=carry[0],
        final_mpc_state=MPCState(carry[1], carry[2]),
        states=states,
        controls=controls,
        terminal_predictions=term_pred,
        termination_states=term_codes,
        constraint_violations=violations,
        solver_iterations=iters,
    )
