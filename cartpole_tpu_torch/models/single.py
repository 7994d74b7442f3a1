"""Rows-form single cart-pole dynamics (counterpart of
``cartpole_tpu/models/single.py:155-184``): thin wrappers that unpack a
``SingleCartPoleParams`` into the generated functions' argument order."""

from __future__ import annotations

from . import _single_gen
from .params import SingleCartPoleParams

__all__ = [
    "STATE_DIM",
    "ANGLE_INDICES",
    "single_cartpole_dynamics_core",
    "single_cartpole_dynamics_jac_core",
]

STATE_DIM = 4
#: Indices of angle coordinates inside the state vector (wrapped to (-pi, pi]).
ANGLE_INDICES = (1,)


def single_cartpole_dynamics_core(params: SingleCartPoleParams, x_rows, u,
                                  forces=None):
    """Rows-out dynamics: ``x_rows`` is a tuple of per-coordinate tensors,
    the return a matching tuple. ``forces``: optional ``(f_b_x, f_b_y,
    f_m_x, f_m_y)`` per-point external forces."""
    return _single_gen.single_dynamics_core(
        params.as_tuple(), x_rows, u, forces
    )


def single_cartpole_dynamics_jac_core(params: SingleCartPoleParams, x_rows,
                                      u):
    """Rows-out ``(x_dot, J_x, J_u)`` as nested tuples (constant entries are
    Python literals, so chain-rule products against them fold away)."""
    return _single_gen.single_dynamics_jac_core(params.as_tuple(), x_rows, u)
