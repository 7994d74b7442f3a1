"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes of kernel 1 and of a whole tick, counted on the plain reference.

:class:`OpCounter` and :func:`op_cost` are a frozen copy of the port's
``utils/roofline.py`` at the commit that added the benchmark: one
operation per output element of an elementwise op, one per input element
of a reduction, 2mnk per matrix product; bytes are the call's tensor
arguments read once and its tensor results written once.

The solve is fixed-trip (``max_iterations`` iterations of
``max_line_search_iterations`` trials each, every instance), so the count
depends on the shapes alone: it is taken per instance at a small batch and
multiplied by the cell's batch. It counts the plain version's work, all
trials of every iteration, whatever implements the kernel.
"""

from __future__ import annotations

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

#: NVIDIA's data-sheet peaks of the H100 SXM at 700 W: HBM3 bytes/s and
#: f32 FLOP/s off the tensor cores.
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12

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

#: Batches the per-instance slope is taken between.
_SMALL = (2, 4)


class OpCounter(TorchDispatchMode):
    """Arithmetic operations of a plain call, as torch dispatches them."""

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


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def op_cost(fn, *args, **kwargs) -> dict:
    """``fn(*args, **kwargs)``'s ``flops`` and ``bytes``."""
    with OpCounter() as c:
        out = fn(*args, **kwargs)
    return {"flops": float(c.ops),
            "bytes": float(_tensor_bytes((args, kwargs))
                           + _tensor_bytes(out))}


def roofline_share(flops: float, nbytes: float, seconds: float) -> float:
    """Percent of the card's roofline: the least time the work could take
    (operations at the f32 peak or bytes at the HBM peak, the larger)
    over ``seconds``."""
    return 100.0 * max(flops / PEAK_F32, nbytes / PEAK_BYTES) / seconds


def _problem(config: dict, traffic: dict, b: int, dtype):
    """The reference's MPC, params and a tick's inputs at batch ``b``,
    from the configuration and traffic files (values do not matter)."""
    from .reference.models import get_model
    from .reference.mpc.config import OptimizationParams
    from .reference.mpc.controller import MPC, MPCState
    from .traffic import episode, rng

    model = get_model(config["model"])
    mpc = MPC(OptimizationParams(**config["optimization"]), model)
    x0s, grid = episode(traffic, model.state_dim, model.angle_indices, 0,
                        0, batch=b)
    fields = dict(config["dynamics"], **grid)
    dp = model.params_type(**{k: torch.as_tensor(v, dtype=dtype)
                              for k, v in fields.items()})
    x = torch.as_tensor(x0s, dtype=dtype)
    state = MPCState(
        previous_solution=torch.as_tensor(
            rng(0, 9).normal(size=(b, mpc.spec.dim)), dtype=dtype),
        warm=torch.ones((b,), dtype=torch.bool))
    return mpc, dp, x, state


def _per_instance(cost_at, batch: int) -> dict:
    """``cost_at(b)`` at the two small batches, scaled by its slope."""
    lo, hi = (cost_at(b) for b in _SMALL)
    return {k: (hi[k] - lo[k]) / (_SMALL[1] - _SMALL[0]) * batch
            for k in ("flops", "bytes")}


def kernel1_cost(config: dict, traffic: dict, batch: int) -> dict:
    """Operations and bytes of one launch of kernel 1 (the whole
    ``max_iterations`` solve of one tick) at ``batch`` instances, in the
    configuration's dtype."""
    from .reference.mpc import lanes as rl
    from .reference.ops.fused import fused_solve

    dtype = getattr(torch, config["dtype"])

    def cost_at(b):
        mpc, dp, x, state = _problem(config, traffic, b, dtype)
        problem, z0 = rl._prepare(mpc, state, x, dp)
        return op_cost(fused_solve, problem.statics.fused, dp,
                       problem.x_current, problem.set_point, problem.u_prev,
                       rl._init_carry(z0, mpc.nls_config),
                       mpc.nls_config.max_iterations)

    return _per_instance(cost_at, batch)


def tick_cost(config: dict, traffic: dict, batch: int) -> dict:
    """Operations and bytes of one whole lanes tick at ``batch``."""
    from .reference.mpc.lanes import tick_fn_lanes

    dtype = getattr(torch, config["dtype"])

    def cost_at(b):
        mpc, dp, x, state = _problem(config, traffic, b, dtype)
        tick = tick_fn_lanes(mpc, dp, torch.zeros((b,), dtype=dtype))
        return op_cost(tick, x.T.contiguous(), state.previous_solution,
                       state.warm)

    return _per_instance(cost_at, batch)
