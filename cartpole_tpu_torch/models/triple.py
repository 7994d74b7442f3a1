"""Triple (three-link) cart-pole dynamics (counterpart of
``cartpole_tpu/models/triple.py``).

State ``[b_x, th_1, th_2, th_3, b_x_dot, th_1_dot, th_2_dot, th_3_dot]``, 8
parameters, no friction, drag or springs. Every function runs the generated
dynamics (``models/_triple_gen.py``); the packed function takes external
forces at the base and at each link mass as the generated core's 8-entry
force tuple.
"""

from __future__ import annotations

import torch

from . import _triple_gen
from .params import TripleCartPoleParams
from .single import pack_jac

__all__ = [
    "STATE_DIM",
    "ANGLE_INDICES",
    "triple_cartpole_dynamics",
    "triple_cartpole_dynamics_core",
    "triple_cartpole_dynamics_jac",
    "triple_cartpole_dynamics_jac_core",
    "triple_cartpole_energy",
]

STATE_DIM = 8
#: Indices of angle coordinates inside the state vector (wrapped to (-pi, pi]).
ANGLE_INDICES = (1, 2, 3)


def _forces_tuple(x, f_base, f_mass, f_mass_2, f_mass_3):
    """The generated core's flat force tuple, zeros where a force is
    absent; ``None`` when every force is."""
    given = (f_base, f_mass, f_mass_2, f_mass_3)
    if all(f is None for f in given):
        return None
    zero = x[0].new_zeros(())
    out = []
    for fv in given:
        out.extend([zero, zero] if fv is None else [fv[0], fv[1]])
    return tuple(out)


def triple_cartpole_dynamics(params: TripleCartPoleParams, x, u, f_base=None,
                             f_mass=None, f_mass_2=None, f_mass_3=None):
    """Packed continuous-time dynamics ``x_dot = f(x, u)``: ``x`` ``(8,
    ...)`` with the batch in the trailing axes, ``u`` broadcastable against
    ``x[0]``; ``f_base``/``f_mass``/``f_mass_2``/``f_mass_3`` optional
    external forces ``(fx, fy)`` at the base and at each link mass. Returns
    ``x_dot`` shaped like ``x``."""
    forces = _forces_tuple(x, f_base, f_mass, f_mass_2, f_mass_3)
    rows = _triple_gen.triple_dynamics_core(params.as_tuple(), x, u, forces)
    return torch.stack(torch.broadcast_tensors(*rows))


def triple_cartpole_dynamics_core(params: TripleCartPoleParams, x_rows, u,
                                  forces=None):
    """Rows-out dynamics: ``x_rows`` is a tuple of per-coordinate tensors,
    the return a matching tuple. ``forces``: optional flat ``(f_b_x, f_b_y,
    f_1_x, f_1_y, ..., f_3_y)``."""
    return _triple_gen.triple_dynamics_core(params.as_tuple(), x_rows, u,
                                            forces)


def triple_cartpole_dynamics_jac_core(params: TripleCartPoleParams, x_rows,
                                      u):
    """Rows-out ``(x_dot, J_x, J_u)`` as nested tuples."""
    return _triple_gen.triple_dynamics_jac_core(params.as_tuple(), x_rows, u)


def triple_cartpole_dynamics_jac(params: TripleCartPoleParams, x, u):
    """``(x_dot, J_x, J_u)`` of one state ``x`` ``(8,)``: ``(8,)``,
    ``(8, 8)``, ``(8,)``, from the generated analytic Jacobians."""
    return pack_jac(*triple_cartpole_dynamics_jac_core(
        params, tuple(x[i] for i in range(STATE_DIM)), u), like=x[0])


def triple_cartpole_energy(params: TripleCartPoleParams, x):
    """Total mechanical energy T + V of packed states ``x`` ``(8, ...)``
    (conserved: the model has no dissipative terms)."""
    b_v = x[4]
    masses = (params.m_1, params.m_2, params.m_3)
    lengths = (params.l_1, params.l_2, params.l_3)
    vx, vy, h = b_v, x.new_zeros(()), x.new_zeros(())
    kinetic = 0.5 * params.m_b * b_v * b_v
    potential = x.new_zeros(())
    for i in range(3):
        th, th_v = x[1 + i], x[5 + i]
        s, c = torch.sin(th), torch.cos(th)
        vx = vx - lengths[i] * s * th_v
        vy = vy + lengths[i] * c * th_v
        h = h + lengths[i] * s
        kinetic = kinetic + 0.5 * masses[i] * (vx * vx + vy * vy)
        potential = potential + masses[i] * params.g * h
    return kinetic + potential
