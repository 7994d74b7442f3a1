"""The cart-pole model families of the port (counterpart of
``cartpole_tpu/models``)."""

from .base import (DOUBLE_CARTPOLE, SINGLE_CARTPOLE, TRIPLE_CARTPOLE,
                   CartPoleModel, get_model)
from .double import double_cartpole_dynamics, double_cartpole_energy
from .params import (DoubleCartPoleParams, SingleCartPoleParams,
                     TripleCartPoleParams, default_double_params,
                     default_single_params, default_triple_params)
from .single import single_cartpole_dynamics, single_cartpole_energy
from .triple import triple_cartpole_dynamics, triple_cartpole_energy

__all__ = [
    "CartPoleModel",
    "SINGLE_CARTPOLE",
    "DOUBLE_CARTPOLE",
    "TRIPLE_CARTPOLE",
    "get_model",
    "SingleCartPoleParams",
    "DoubleCartPoleParams",
    "TripleCartPoleParams",
    "default_single_params",
    "default_double_params",
    "default_triple_params",
    "single_cartpole_dynamics",
    "single_cartpole_energy",
    "double_cartpole_dynamics",
    "double_cartpole_energy",
    "triple_cartpole_dynamics",
    "triple_cartpole_energy",
]
