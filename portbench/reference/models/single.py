"""Single cart-pole dynamics (counterpart of
``cartpole_tpu/models/single.py``).

The rows-form functions are thin wrappers that unpack a
``SingleCartPoleParams`` into the generated functions' argument order. The
packed function with external forces is the hand-derived closed form of the
reference (``models/single.py:49-132``), which the disturbed plant runs.
"""

from __future__ import annotations

import torch

from . import _single_gen
from .params import SingleCartPoleParams

__all__ = [
    "STATE_DIM",
    "ANGLE_INDICES",
    "single_cartpole_dynamics",
    "single_cartpole_dynamics_core",
    "single_cartpole_dynamics_jac",
    "single_cartpole_dynamics_jac_core",
    "pack_jac",
    "single_cartpole_energy",
]

STATE_DIM = 4
#: Indices of angle coordinates inside the state vector (wrapped to (-pi, pi]).
ANGLE_INDICES = (1,)


def _safe_speed(vx, vy):
    """|v|, 0 at v = 0, with the ``where`` inside the sqrt argument (the
    reference's zero-safe form, ``dynamics_single.py:104-108``)."""
    n2 = vx * vx + vy * vy
    pos = n2 > 0
    n2_safe = torch.where(pos, n2, 1.0)
    return torch.where(pos, torch.sqrt(n2_safe), 0.0)


def single_cartpole_dynamics(params: SingleCartPoleParams, x, u, f_base=None,
                             f_mass=None):
    """Packed continuous-time dynamics ``x_dot = f(x, u)``: ``x`` ``(4,
    ...)`` with the batch in the trailing axes, ``u`` broadcastable against
    ``x[0]``; ``f_base``/``f_mass`` optional external forces ``(fx, fy)``
    at the base and at the pole mass (each component broadcastable). Returns
    ``x_dot`` shaped like ``x``."""
    b_x, th, b_v, th_v = x[0], x[1], x[2], x[3]
    m_b, m_1, l_1, g = params.m_b, params.m_1, params.l_1, params.g
    s, c = torch.sin(th), torch.cos(th)

    # Pole-mass velocity: p1 = (b_x + l_1 c, l_1 s) => v1 = d p1 / dt.
    v1x = b_v - l_1 * s * th_v
    v1y = l_1 * c * th_v

    # Generalized external forces: Q_q = f . dp/dq for each applied point.
    q_b = x.new_zeros(())
    q_th = x.new_zeros(())
    if f_base is not None:
        q_b = q_b + f_base[0]
    if f_mass is not None:
        q_b = q_b + f_mass[0]
        q_th = q_th + l_1 * (-s * f_mass[0] + c * f_mass[1])

    f_fric = -params.mu_b * (m_b + m_1) * g * torch.tanh(
        b_v / torch.clamp_min(params.v_mu_b, 1e-6))

    # Air drag from the Rayleigh dissipation function D = c_d |v|^3 / 6.
    speed = _safe_speed(v1x, v1y)
    drag_b = 0.5 * params.c_d_1 * speed * v1x
    drag_th = 0.5 * params.c_d_1 * speed * l_1 * (c * v1y - s * v1x)

    f_spring = (-params.k_s * torch.clamp_min(b_x - params.x_s, 0.0)
                + params.k_s * torch.clamp_min(-params.x_s - b_x, 0.0))

    rhs_b = u + q_b + f_fric + f_spring + m_1 * l_1 * c * th_v * th_v - drag_b
    rhs_th = -m_1 * g * l_1 * c + q_th - drag_th

    # Closed-form 2x2 inverse of the mass matrix.
    det = m_1 * l_1 * l_1 * (m_b + m_1 * c * c)
    b_acc = (m_1 * l_1 * l_1 * rhs_b + m_1 * l_1 * s * rhs_th) / det
    th_acc = (m_1 * l_1 * s * rhs_b + (m_b + m_1) * rhs_th) / det
    return torch.stack(torch.broadcast_tensors(b_v, th_v, b_acc, th_acc))


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


def pack_jac(x_dot_rows, J_x_rows, J_u_rows, like):
    """Pack a rows-form ``(x_dot, J_x, J_u)`` into tensors ``(sd,)``, ``(sd,
    sd)``, ``(sd,)``: the Python literals become tensors through ``e +
    like * 0.0``, as the reference packs them (``_single_gen.py:175-184``).
    """
    zero = like * 0.0
    return (torch.stack(x_dot_rows),
            torch.stack([torch.stack([e + zero for e in row])
                         for row in J_x_rows]),
            torch.stack([e + zero for e in J_u_rows]))


def single_cartpole_dynamics_jac(params: SingleCartPoleParams, x, u):
    """``(x_dot, J_x, J_u)`` of one state ``x`` ``(4,)``: ``(4,)``, ``(4,
    4)``, ``(4,)``, from the generated analytic Jacobians (the reference's
    ``single_cartpole_dynamics_jac``, ``models/single.py:135-152``)."""
    return pack_jac(*single_cartpole_dynamics_jac_core(
        params, tuple(x[i] for i in range(STATE_DIM)), u), like=x[0])


def single_cartpole_energy(params: SingleCartPoleParams, x):
    """Total mechanical energy T + V of packed states ``x`` ``(4, ...)``
    (conserved when mu_b = c_d_1 = k_s = 0 with no control or external
    force)."""
    th, b_v, th_v = x[1], x[2], x[3]
    m_b, m_1, l_1, g = params.m_b, params.m_1, params.l_1, params.g
    s, c = torch.sin(th), torch.cos(th)
    v1x = b_v - l_1 * s * th_v
    v1y = l_1 * c * th_v
    kinetic = 0.5 * m_b * b_v * b_v + 0.5 * m_1 * (v1x * v1x + v1y * v1y)
    potential = m_1 * g * l_1 * s
    return kinetic + potential
