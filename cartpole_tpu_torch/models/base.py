"""Model descriptors (counterpart of ``cartpole_tpu/models/base.py``).

Only the single cart-pole is registered in the port so far; the double and
triple models are queued in ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

from . import single as _single
from .params import SingleCartPoleParams

__all__ = ["CartPoleModel", "SINGLE_CARTPOLE", "get_model"]


@dataclasses.dataclass(frozen=True)
class CartPoleModel:
    """Static description of a dynamics family."""

    name: str
    state_dim: int
    #: Indices of angle coordinates in the state vector (wrapped to (-pi, pi]).
    angle_indices: Tuple[int, ...]
    #: Constructor for the parameter dataclass.
    params_type: type
    #: f(params, x, u, f_base=None, f_mass=None) -> x_dot, packed (sd, ...).
    dynamics: Callable[..., Any]
    #: f(params, x_rows, u) -> x_dot_rows (tuples of per-coordinate tensors).
    dynamics_core: Callable[..., Any]
    #: fj(params, x_rows, u) -> (x_dot_rows, J_x_rows, J_u_rows).
    dynamics_jac_core: Callable[..., Any]


SINGLE_CARTPOLE = CartPoleModel(
    name="single",
    state_dim=_single.STATE_DIM,
    angle_indices=_single.ANGLE_INDICES,
    params_type=SingleCartPoleParams,
    dynamics=_single.single_cartpole_dynamics,
    dynamics_core=_single.single_cartpole_dynamics_core,
    dynamics_jac_core=_single.single_cartpole_dynamics_jac_core,
)

_REGISTRY = {m.name: m for m in (SINGLE_CARTPOLE,)}


def get_model(name: str) -> CartPoleModel:
    """Look up a model family by name (only ``"single"`` so far)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(_REGISTRY)}"
        ) from None
