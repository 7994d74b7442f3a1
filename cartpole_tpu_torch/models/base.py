"""Model descriptors (counterpart of ``cartpole_tpu/models/base.py``): the
single, double and triple cart-pole, each described once; every layer of
the port is generic over them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

from . import double as _double
from . import single as _single
from . import triple as _triple
from .params import (DoubleCartPoleParams, SingleCartPoleParams,
                     TripleCartPoleParams)

__all__ = ["CartPoleModel", "SINGLE_CARTPOLE", "DOUBLE_CARTPOLE",
           "TRIPLE_CARTPOLE", "get_model"]


@dataclasses.dataclass(frozen=True)
class CartPoleModel:
    """Static description of a dynamics family."""

    name: str
    state_dim: int
    #: Indices of angle coordinates in the state vector (wrapped to (-pi, pi]).
    angle_indices: Tuple[int, ...]
    #: Constructor for the parameter dataclass.
    params_type: type
    #: f(params, x, u, f_base=None, f_mass=None, ...) -> x_dot, packed
    #: (sd, ...); one optional (fx, fy) force per link mass after f_mass.
    dynamics: Callable[..., Any]
    #: f(params, x_rows, u) -> x_dot_rows (tuples of per-coordinate tensors).
    dynamics_core: Callable[..., Any]
    #: fj(params, x_rows, u) -> (x_dot_rows, J_x_rows, J_u_rows).
    dynamics_jac_core: Callable[..., Any]
    #: fj(params, x, u) -> (x_dot, J_x, J_u) of one packed state ``(sd,)``:
    #: the generated analytic Jacobians, packed (``analytic_jacobians``).
    dynamics_jac: Callable[..., Any]
    #: E(params, x) -> total mechanical energy of packed states.
    energy: Callable[..., Any]


SINGLE_CARTPOLE = CartPoleModel(
    name="single",
    state_dim=_single.STATE_DIM,
    angle_indices=_single.ANGLE_INDICES,
    params_type=SingleCartPoleParams,
    dynamics=_single.single_cartpole_dynamics,
    dynamics_core=_single.single_cartpole_dynamics_core,
    dynamics_jac_core=_single.single_cartpole_dynamics_jac_core,
    dynamics_jac=_single.single_cartpole_dynamics_jac,
    energy=_single.single_cartpole_energy,
)

DOUBLE_CARTPOLE = CartPoleModel(
    name="double",
    state_dim=_double.STATE_DIM,
    angle_indices=_double.ANGLE_INDICES,
    params_type=DoubleCartPoleParams,
    dynamics=_double.double_cartpole_dynamics,
    dynamics_core=_double.double_cartpole_dynamics_core,
    dynamics_jac_core=_double.double_cartpole_dynamics_jac_core,
    dynamics_jac=_double.double_cartpole_dynamics_jac,
    energy=_double.double_cartpole_energy,
)

TRIPLE_CARTPOLE = CartPoleModel(
    name="triple",
    state_dim=_triple.STATE_DIM,
    angle_indices=_triple.ANGLE_INDICES,
    params_type=TripleCartPoleParams,
    dynamics=_triple.triple_cartpole_dynamics,
    dynamics_core=_triple.triple_cartpole_dynamics_core,
    dynamics_jac_core=_triple.triple_cartpole_dynamics_jac_core,
    dynamics_jac=_triple.triple_cartpole_dynamics_jac,
    energy=_triple.triple_cartpole_energy,
)

_REGISTRY = {m.name: m for m in (SINGLE_CARTPOLE, DOUBLE_CARTPOLE,
                                 TRIPLE_CARTPOLE)}


def get_model(name: str) -> CartPoleModel:
    """Look up a model family by name: ``"single"``, ``"double"`` or
    ``"triple"``."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(_REGISTRY)}"
        ) from None
