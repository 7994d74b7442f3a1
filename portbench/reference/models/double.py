"""Double (two-link) cart-pole dynamics (counterpart of
``cartpole_tpu/models/double.py``).

State ``[b_x, th_1, th_2, b_x_dot, th_1_dot, th_2_dot]``, 6 parameters, no
friction, drag or springs. The rows-form functions unpack a
``DoubleCartPoleParams`` into the generated functions' argument order
(``models/_double_gen.py``). The packed function with external forces is the
reference's hand-derived closed form (``models/double.py:45-126``): the 3x3
mass matrix solved by its adjugate, which the disturbed plant runs.
"""

from __future__ import annotations

import torch

from . import _double_gen
from .params import DoubleCartPoleParams
from .single import pack_jac

__all__ = [
    "STATE_DIM",
    "ANGLE_INDICES",
    "double_cartpole_dynamics",
    "double_cartpole_dynamics_core",
    "double_cartpole_dynamics_jac",
    "double_cartpole_dynamics_jac_core",
    "double_cartpole_energy",
]

STATE_DIM = 6
#: Indices of angle coordinates inside the state vector (wrapped to (-pi, pi]).
ANGLE_INDICES = (1, 2)


def _solve_sym3(a11, a12, a13, a22, a23, a33, b1, b2, b3):
    """Solve a symmetric 3x3 system by its adjugate."""
    c11 = a22 * a33 - a23 * a23
    c12 = a13 * a23 - a12 * a33
    c13 = a12 * a23 - a13 * a22
    c22 = a11 * a33 - a13 * a13
    c23 = a12 * a13 - a11 * a23
    c33 = a11 * a22 - a12 * a12
    det = a11 * c11 + a12 * c12 + a13 * c13
    x1 = (c11 * b1 + c12 * b2 + c13 * b3) / det
    x2 = (c12 * b1 + c22 * b2 + c23 * b3) / det
    x3 = (c13 * b1 + c23 * b2 + c33 * b3) / det
    return x1, x2, x3


def double_cartpole_dynamics(params: DoubleCartPoleParams, x, u, f_base=None,
                             f_mass=None, f_mass_2=None):
    """Packed continuous-time dynamics ``x_dot = f(x, u)``: ``x`` ``(6,
    ...)`` with the batch in the trailing axes, ``u`` broadcastable against
    ``x[0]``; ``f_base``/``f_mass``/``f_mass_2`` optional external forces
    ``(fx, fy)`` at the base and at the first and second link masses (each
    component broadcastable). Returns ``x_dot`` shaped like ``x``."""
    th1, th2 = x[1], x[2]
    b_v, th1_v, th2_v = x[3], x[4], x[5]
    m_b, m_1, m_2 = params.m_b, params.m_1, params.m_2
    l_1, l_2, g = params.l_1, params.l_2, params.g

    s1, c1 = torch.sin(th1), torch.cos(th1)
    s2, c2 = torch.sin(th2), torch.cos(th2)
    s12 = s1 * c2 - c1 * s2  # sin(th1 - th2)
    c12 = c1 * c2 + s1 * s2  # cos(th1 - th2)

    m12 = m_1 + m_2

    # Mass matrix entries (symmetric).
    a11 = m_b + m12
    a12 = -m12 * l_1 * s1
    a13 = -m_2 * l_2 * s2
    a22 = m12 * l_1 * l_1
    a23 = m_2 * l_1 * l_2 * c12
    a33 = m_2 * l_2 * l_2

    # Generalized external forces: Q_q = sum_i f_i . dp_i/dq.
    q_x = x.new_zeros(())
    q_1 = x.new_zeros(())
    q_2 = x.new_zeros(())
    if f_base is not None:
        q_x = q_x + f_base[0]
    if f_mass is not None:
        q_x = q_x + f_mass[0]
        q_1 = q_1 + l_1 * (-s1 * f_mass[0] + c1 * f_mass[1])
    if f_mass_2 is not None:
        q_x = q_x + f_mass_2[0]
        q_1 = q_1 + l_1 * (-s1 * f_mass_2[0] + c1 * f_mass_2[1])
        q_2 = q_2 + l_2 * (-s2 * f_mass_2[0] + c2 * f_mass_2[1])

    b1 = (u + q_x + m12 * l_1 * c1 * th1_v * th1_v
          + m_2 * l_2 * c2 * th2_v * th2_v)
    b2 = q_1 - m_2 * l_1 * l_2 * s12 * th2_v * th2_v - m12 * g * l_1 * c1
    b3 = q_2 + m_2 * l_1 * l_2 * s12 * th1_v * th1_v - m_2 * g * l_2 * c2

    b_acc, th1_acc, th2_acc = _solve_sym3(a11, a12, a13, a22, a23, a33, b1,
                                          b2, b3)
    return torch.stack(torch.broadcast_tensors(
        b_v, th1_v, th2_v, b_acc, th1_acc, th2_acc))


def double_cartpole_dynamics_core(params: DoubleCartPoleParams, x_rows, u,
                                  forces=None):
    """Rows-out dynamics: ``x_rows`` is a tuple of per-coordinate tensors,
    the return a matching tuple. ``forces``: optional ``(f_b_x, f_b_y,
    f_1_x, f_1_y, f_2_x, f_2_y)``."""
    return _double_gen.double_dynamics_core(params.as_tuple(), x_rows, u,
                                            forces)


def double_cartpole_dynamics_jac_core(params: DoubleCartPoleParams, x_rows,
                                      u):
    """Rows-out ``(x_dot, J_x, J_u)`` as nested tuples (constant entries are
    Python literals, so chain-rule products against them fold away)."""
    return _double_gen.double_dynamics_jac_core(params.as_tuple(), x_rows, u)


def double_cartpole_dynamics_jac(params: DoubleCartPoleParams, x, u):
    """``(x_dot, J_x, J_u)`` of one state ``x`` ``(6,)``: ``(6,)``,
    ``(6, 6)``, ``(6,)``, from the generated analytic Jacobians."""
    return pack_jac(*double_cartpole_dynamics_jac_core(
        params, tuple(x[i] for i in range(STATE_DIM)), u), like=x[0])


def double_cartpole_energy(params: DoubleCartPoleParams, x):
    """Total mechanical energy T + V of packed states ``x`` ``(6, ...)``
    (conserved: the model has no dissipative terms)."""
    th1, th2 = x[1], x[2]
    b_v, th1_v, th2_v = x[3], x[4], x[5]
    m_b, m_1, m_2 = params.m_b, params.m_1, params.m_2
    l_1, l_2, g = params.l_1, params.l_2, params.g
    s1, c1 = torch.sin(th1), torch.cos(th1)
    s2, c2 = torch.sin(th2), torch.cos(th2)
    v1x = b_v - l_1 * s1 * th1_v
    v1y = l_1 * c1 * th1_v
    v2x = v1x - l_2 * s2 * th2_v
    v2y = v1y + l_2 * c2 * th2_v
    kinetic = (
        0.5 * m_b * b_v * b_v
        + 0.5 * m_1 * (v1x * v1x + v1y * v1y)
        + 0.5 * m_2 * (v2x * v2x + v2y * v2y)
    )
    potential = m_1 * g * l_1 * s1 + m_2 * g * (l_1 * s1 + l_2 * s2)
    return kinetic + potential
