"""Per-instance integration ops: angle wrap, RK4 and rollouts (counterpart
of ``cartpole_tpu/ops/integrate.py``).

A state is one ``(..., sd)`` tensor with the coordinates in its LAST axis,
as in the reference; the batch, if any, comes from ``torch.func.vmap``.
Each ``lax.scan`` of the reference is a Python loop that stacks its
outputs. Every function is functional (no in-place writes), so it runs
under ``torch.func``'s transforms (``vmap``, ``jacrev``).
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

__all__ = [
    "mod_pi",
    "wrap_angles",
    "rk4_step",
    "rk4_step_with_jac",
    "rollout",
    "segment_rollout_with_jac",
    "split_substeps",
    "substep_rollout",
]

_TWO_PI = 2.0 * math.pi


def mod_pi(angle):
    """Wrap an angle to ``(-pi, pi]``: ``mod_pi(pi) == mod_pi(-pi) == pi``.

    ``torch.remainder`` takes the sign of the divisor, as ``jnp.mod`` does,
    so ``pi - remainder(pi - angle, 2 pi)`` maps exactly onto ``(-pi, pi]``.
    """
    return math.pi - torch.remainder(math.pi - angle, _TWO_PI)


def wrap_angles(x, angle_indices: Tuple[int, ...]):
    """``mod_pi`` the given coordinates of the last axis of ``x``; returns
    a new tensor."""
    for i in angle_indices:
        x = torch.cat([x[..., :i], mod_pi(x[..., i:i + 1]), x[..., i + 1:]],
                      dim=-1)
    return x


def rk4_step(f: Callable, x, u, h):
    """One classic RK4 step of ``x' = f(x, u)`` (``integration.hpp:52-62``)."""
    k1 = f(x, u)
    k2 = f(x + k1 * (h * 0.5), u)
    k3 = f(x + k2 * (h * 0.5), u)
    k4 = f(x + k3 * h, u)
    return x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def rk4_step_with_jac(fj: Callable, x, u, h):
    """One RK4 step with its Jacobians by the four-stage chain rule
    (``integration.hpp:13-49``). ``fj(x, u) -> (x_dot, J_x, J_u)``.

    Returns ``(x_next, A, B)`` with ``A = dx_next/dx`` (sd, sd) and
    ``B = dx_next/du`` (sd,)."""
    sd = x.shape[-1]
    eye = torch.eye(sd, dtype=x.dtype, device=x.device)

    k1, A1, B1 = fj(x, u)
    x2 = x + k1 * (h * 0.5)
    k2, A2, B2 = fj(x2, u)
    dk2_dx = A2 @ (eye + (h * 0.5) * A1)
    dk2_du = A2 @ ((h * 0.5) * B1) + B2

    x3 = x + k2 * (h * 0.5)
    k3, A3, B3 = fj(x3, u)
    dk3_dx = A3 @ (eye + (h * 0.5) * dk2_dx)
    dk3_du = A3 @ ((h * 0.5) * dk2_du) + B3

    x4 = x + k3 * h
    k4, A4, B4 = fj(x4, u)
    dk4_dx = A4 @ (eye + h * dk3_dx)
    dk4_du = A4 @ (h * dk3_du) + B4

    x_next = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    A = eye + (h / 6.0) * (A1 + 2.0 * dk2_dx + 2.0 * dk3_dx + dk4_dx)
    B = (h / 6.0) * (B1 + 2.0 * dk2_du + 2.0 * dk3_du + dk4_du)
    return x_next, A, B


def segment_rollout_with_jac(fj: Callable, x0, us, h,
                             angle_indices: Tuple[int, ...] = ()):
    """Integrate a control segment ``us`` (T,) with its Jacobians: returns
    ``(x_end, Jx, Ju)``, ``Jx = dx_end/dx0`` (sd, sd) and ``Ju =
    dx_end/dus`` (sd, T). The angle wrap has unit derivative, so it only
    touches the state."""
    sd = x0.shape[-1]
    x = x0
    Jx = torch.eye(sd, dtype=x0.dtype, device=x0.device)
    cols = []
    for k in range(us.shape[-1]):
        x, A, B = rk4_step_with_jac(fj, x, us[k], h)
        x = wrap_angles(x, angle_indices)
        Jx = A @ Jx
        cols = [A @ c for c in cols]
        cols.append(B)
    return x, Jx, torch.stack(cols, dim=1)


def rollout(f: Callable, x0, us, h, angle_indices: Tuple[int, ...] = ()):
    """Integrate a control sequence ``us`` (T,) from ``x0`` (sd,), wrapping
    the angles after every step (``optimization.cc:117-137, 333-371``).

    Returns ``(x_final, xs)``, ``xs`` (T, sd) the state after each control
    (``xs[-1] == x_final``)."""
    x = x0
    xs = []
    for k in range(us.shape[0]):
        x = wrap_angles(rk4_step(f, x, us[k], h), angle_indices)
        xs.append(x)
    return x, torch.stack(xs)


def split_substeps(dt: float, internal_dt: float = 1.0e-3):
    """Static substep schedule for the plant integrator: ``(n_full,
    remainder)`` such that ``dt = n_full * internal_dt + remainder`` with
    ``remainder`` dropped below 1e-12 (``simulator.cc:17-23`` arithmetic)."""
    n_full = int(dt / internal_dt)
    remainder = dt - n_full * internal_dt
    if remainder <= 1e-12:
        remainder = 0.0
    return n_full, remainder


def substep_rollout(f: Callable, x0, u, dt: float,
                    internal_dt: float = 1.0e-3,
                    angle_indices: Tuple[int, ...] = ()):
    """Integrate a constant control over ``dt`` in ``internal_dt`` substeps,
    a short last one where ``dt`` is not a multiple (``simulator.cc:17-23``).
    """
    n_full, remainder = split_substeps(dt, internal_dt)
    x = x0
    for h in [internal_dt] * n_full + ([remainder] if remainder else []):
        x = wrap_angles(rk4_step(f, x, u, h), angle_indices)
    return x
