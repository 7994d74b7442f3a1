"""Batch-last integration ops (counterpart of ``cartpole_tpu/ops/lanes.py``).

Packed form: a state is one ``(sd, M)`` tensor and a Jacobian ``(sd, sd,
M)``; the tiny matrix products are broadcast-multiply-reduce over the
trailing lane axis. Rows form (structure of arrays): a state is a TUPLE of
per-coordinate tensors sharing one trailing batch shape, and Jacobians are
nested tuples whose entries are tensors or the Python literals
``0.0``/``1.0``, which the products below fold away. Each ``lax.scan`` of
the reference is a Python loop here.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .integrate import mod_pi

__all__ = [
    "bmat",
    "bmv",
    "beye",
    "wrap_angles_lanes",
    "rk4_step_lanes",
    "rk4_step_with_jac_lanes",
    "segment_rollout_with_jac_lanes",
    "rollout_lanes",
    "wrap_angles_rows",
    "rk4_step_rows",
    "rollout_rows",
    "rk4_step_with_jac_rows",
    "segment_rollout_with_jac_rows",
    "segment_rollout_with_jac_scan",
]


def bmat(A, B):
    """Batched tiny-matrix product ``(i,j,M) x (j,k,M) -> (i,k,M)``."""
    return torch.sum(A[:, :, None] * B[None, :, :], dim=1)


def bmv(A, x):
    """Batched tiny matrix-vector product ``(i,j,M) x (j,M) -> (i,M)``."""
    return torch.sum(A * x[None, :, :], dim=1)


def beye(n, dtype, device=None):
    """Identity broadcastable against ``(n, n, M)``."""
    return torch.eye(n, dtype=dtype, device=device)[:, :, None]


def wrap_angles_lanes(x, angle_indices: Tuple[int, ...]):
    """``mod_pi`` the given leading coordinates of ``x`` (sd, M); returns a
    new tensor."""
    return torch.stack([
        mod_pi(x[i]) if i in angle_indices else x[i]
        for i in range(x.shape[0])
    ])


def rk4_step_lanes(f: Callable, x, u, h):
    """One RK4 step, batch-last: ``x`` (sd, M), ``u`` (M,)."""
    k1 = f(x, u)
    k2 = f(x + k1 * (h * 0.5), u)
    k3 = f(x + k2 * (h * 0.5), u)
    k4 = f(x + k3 * h, u)
    return x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def rk4_step_with_jac_lanes(fj: Callable, x, u, h):
    """One RK4 step with the chain-ruled Jacobians, batch-last.

    ``fj(x, u) -> (x_dot (sd, M), J_x (sd, sd, M), J_u (sd, M))``, for
    example ``model.dynamics_jac`` on lane-batched inputs. Returns ``(x_next
    (sd, M), A (sd, sd, M), B (sd, M))``.
    """
    sd = x.shape[0]
    eye = beye(sd, x.dtype, x.device)

    k1, A1, B1 = fj(x, u)
    k2, A2, B2 = fj(x + k1 * (h * 0.5), u)
    dk2_dx = bmat(A2, eye + (h * 0.5) * A1)
    dk2_du = bmv(A2, (h * 0.5) * B1) + B2

    k3, A3, B3 = fj(x + k2 * (h * 0.5), u)
    dk3_dx = bmat(A3, eye + (h * 0.5) * dk2_dx)
    dk3_du = bmv(A3, (h * 0.5) * dk2_du) + B3

    k4, A4, B4 = fj(x + k3 * h, u)
    dk4_dx = bmat(A4, eye + h * dk3_dx)
    dk4_du = bmv(A4, h * dk3_du) + B4

    x_next = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    A = eye + (h / 6.0) * (A1 + 2.0 * dk2_dx + 2.0 * dk3_dx + dk4_dx)
    B = (h / 6.0) * (B1 + 2.0 * dk2_du + 2.0 * dk3_du + dk4_du)
    return x_next, A, B


def segment_rollout_with_jac_lanes(fj: Callable, x0, us, h,
                                   angle_indices: Tuple[int, ...] = ()):
    """One shooting segment with its Jacobians, batch-last: ``x0`` (sd,
    M), ``us`` (T, M) -> ``(x_end (sd, M), Jx (sd, sd, M), Ju (sd, T,
    M))``. The angle wrap has unit derivative, so it touches only the
    state."""
    sd = x0.shape[0]
    x = x0
    Jx = beye(sd, x0.dtype, x0.device).expand(sd, sd, x0.shape[1])
    cols = []
    for k in range(us.shape[0]):
        x, A, B = rk4_step_with_jac_lanes(fj, x, us[k], h)
        x = wrap_angles_lanes(x, angle_indices)
        Jx = bmat(A, Jx)
        cols = [bmv(A, c) for c in cols]
        cols.append(B)
    return x, Jx, torch.stack(cols, dim=1)


def rollout_lanes(f: Callable, x0, us, h,
                  angle_indices: Tuple[int, ...] = (),
                  stack_states: bool = False):
    """A control sequence integrated batch-last, without Jacobians: ``x0``
    (sd, M), ``us`` (T, M). Returns ``x_final`` (sd, M), or ``(x_final, xs
    (sd, T, M))`` with ``stack_states`` (the state after each control)."""
    x = x0
    states = []
    for k in range(us.shape[0]):
        x = wrap_angles_lanes(rk4_step_lanes(f, x, us[k], h), angle_indices)
        if stack_states:
            states.append(x)
    if stack_states:
        return x, torch.stack(states, dim=1)
    return x


def _axpy_rows(x_rows, k_rows, a):
    """x + a*k, row-tuple-wise."""
    return tuple(x + a * k for x, k in zip(x_rows, k_rows))


def wrap_angles_rows(x_rows, angle_indices: Tuple[int, ...]):
    """``mod_pi`` the given coordinates of a row tuple."""
    return tuple(
        mod_pi(x) if i in angle_indices else x
        for i, x in enumerate(x_rows)
    )


def rk4_step_rows(f: Callable, x_rows, u, h):
    """One RK4 step on a row tuple: ``f(x_rows, u) -> x_dot_rows``."""
    k1 = f(x_rows, u)
    k2 = f(_axpy_rows(x_rows, k1, h * 0.5), u)
    k3 = f(_axpy_rows(x_rows, k2, h * 0.5), u)
    k4 = f(_axpy_rows(x_rows, k3, h), u)
    return tuple(
        x + (h / 6.0) * (a + 2.0 * b + 2.0 * c + d)
        for x, a, b, c, d in zip(x_rows, k1, k2, k3, k4)
    )


def rollout_rows(f: Callable, x0_rows, us, h,
                 angle_indices: Tuple[int, ...] = (),
                 stack_states: bool = False):
    """Rows-tuple rollout over ``us`` ``(T, ...)``: returns the final row
    tuple, or ``(final, per_step)`` where ``per_step`` is a row tuple of
    ``(T, ...)`` tensors (the state after each control)."""
    x = tuple(x0_rows)
    states = []
    for k in range(us.shape[0]):
        x = wrap_angles_rows(rk4_step_rows(f, x, us[k], h), angle_indices)
        if stack_states:
            states.append(x)
    if stack_states:
        return x, tuple(
            torch.stack([s[i] for s in states]) for i in range(len(x))
        )
    return x


def _mat_rows(A, B, sd: int):
    """Nested-tuple matmul ``A @ B`` with 0.0/1.0 literal folding."""

    def term(a, b):
        if isinstance(a, float) and a == 0.0:
            return None
        if isinstance(b, float) and b == 0.0:
            return None
        if isinstance(a, float) and a == 1.0:
            return b
        if isinstance(b, float) and b == 1.0:
            return a
        return a * b

    out = []
    for i in range(sd):
        row = []
        for j in range(sd):
            acc = None
            for k in range(sd):
                t = term(A[i][k], B[k][j])
                if t is None:
                    continue
                acc = t if acc is None else acc + t
            row.append(0.0 if acc is None else acc)
        out.append(tuple(row))
    return tuple(out)


def _matvec_rows(A, v, sd: int):
    """Nested-tuple mat-vec with literal folding; ``v`` a row tuple."""
    out = []
    for i in range(sd):
        acc = None
        for k in range(sd):
            a = A[i][k]
            if isinstance(a, float) and a == 0.0:
                continue
            vk = v[k]
            if isinstance(vk, float) and vk == 0.0:
                continue
            t = vk if isinstance(a, float) and a == 1.0 else (
                a if isinstance(vk, float) and vk == 1.0 else a * vk
            )
            acc = t if acc is None else acc + t
        out.append(0.0 if acc is None else acc)
    return tuple(out)


def _add_scaled_mat(A, B, s, sd: int):
    """A + s*B elementwise over nested tuples with literal folding."""
    out = []
    for i in range(sd):
        row = []
        for j in range(sd):
            a, b = A[i][j], B[i][j]
            if isinstance(b, float) and b == 0.0:
                row.append(a)
            elif isinstance(a, float) and a == 0.0:
                row.append(s * b)
            else:
                row.append(a + s * b)
        out.append(tuple(row))
    return tuple(out)


def _eye_rows(sd: int):
    return tuple(
        tuple(1.0 if i == j else 0.0 for j in range(sd)) for i in range(sd)
    )


def rk4_step_with_jac_rows(fj: Callable, x_rows, u, h):
    """One RK4 step with chain-ruled Jacobians, rows form.

    ``fj(x_rows, u) -> (x_dot_rows, J_x_rows, J_u_rows)``. Returns
    ``(x_next_rows, A_rows, B_rows)``, ``A = dx_next/dx``, ``B =
    dx_next/du`` (the four-stage chain rule of ``integration.hpp:13-49``).
    """
    sd = len(x_rows)
    eye = _eye_rows(sd)

    k1, A1, B1 = fj(x_rows, u)
    k2, A2, B2 = fj(_axpy_rows(x_rows, k1, h * 0.5), u)
    dk2_dx = _mat_rows(A2, _add_scaled_mat(eye, A1, h * 0.5, sd), sd)
    dk2_du = tuple(
        a + b for a, b in zip(
            _matvec_rows(A2, tuple((h * 0.5) * e for e in B1), sd), B2
        )
    )

    k3, A3, B3 = fj(_axpy_rows(x_rows, k2, h * 0.5), u)
    dk3_dx = _mat_rows(A3, _add_scaled_mat(eye, dk2_dx, h * 0.5, sd), sd)
    dk3_du = tuple(
        a + b for a, b in zip(
            _matvec_rows(A3, tuple((h * 0.5) * e for e in dk2_du), sd), B3
        )
    )

    k4, A4, B4 = fj(_axpy_rows(x_rows, k3, h), u)
    dk4_dx = _mat_rows(A4, _add_scaled_mat(eye, dk3_dx, h, sd), sd)
    dk4_du = tuple(
        a + b for a, b in zip(
            _matvec_rows(A4, tuple(h * e for e in dk3_du), sd), B4
        )
    )

    x_next = tuple(
        x + (h / 6.0) * (a + 2.0 * b + 2.0 * c + d)
        for x, a, b, c, d in zip(x_rows, k1, k2, k3, k4)
    )
    A = tuple(
        tuple(
            (1.0 if i == j else 0.0)
            + (h / 6.0)
            * (A1[i][j] + 2.0 * dk2_dx[i][j] + 2.0 * dk3_dx[i][j]
               + dk4_dx[i][j])
            for j in range(sd)
        )
        for i in range(sd)
    )
    B = tuple(
        (h / 6.0) * (a + 2.0 * b + 2.0 * c + d)
        for a, b, c, d in zip(B1, dk2_du, dk3_du, dk4_du)
    )
    return x_next, A, B


def segment_rollout_with_jac_rows(fj: Callable, x0_rows, us, h,
                                  angle_indices: Tuple[int, ...] = ()):
    """Rows-form shooting-segment rollout with accumulated Jacobians.

    ``us`` ``(T, ...)``. Returns ``(x_end_rows, Jx_rows (sd x sd nested),
    Ju_cols)`` where ``Ju_cols[k]`` is the row tuple ``d x_end / d u_k``.
    The angle wrap has unit derivative, so it only touches the state.
    """
    sd = len(x0_rows)
    x = tuple(x0_rows)
    Jx = _eye_rows(sd)
    cols = []
    for k in range(us.shape[0]):
        x, A, B = rk4_step_with_jac_rows(fj, x, us[k], h)
        x = wrap_angles_rows(x, angle_indices)
        Jx = _mat_rows(A, Jx, sd)
        cols = [_matvec_rows(A, c, sd) for c in cols]
        cols.append(B)
    return x, Jx, cols


def segment_rollout_with_jac_scan(fj: Callable, x0_rows, us, h,
                                  angle_indices: Tuple[int, ...] = ()):
    """Shooting-segment Jacobian rollout: rows inside, packed out.

    The per-step dynamics and within-step RK4 chain rule run in rows form;
    the cross-step accumulation (``Jx = A_k Jx``, the ``Ju`` column
    updates) runs packed afterwards. ``x0_rows`` row tuple of ``(M,)``;
    ``us`` ``(T, M)``. Returns packed ``(x_end (sd, M), Jx (sd, sd, M), Ju
    (sd, T, M))``, the contract of the reference's function of the same
    name.
    """
    sd = len(x0_rows)
    T, M = us.shape
    like = us[0]

    def pack_mat(A_rows):
        return torch.stack([
            torch.stack([torch.broadcast_to(torch.as_tensor(
                e, dtype=like.dtype, device=like.device), (M,)) for e in row])
            for row in A_rows
        ])

    x = tuple(x0_rows)
    As, Bs = [], []
    for k in range(T):
        x, A, B = rk4_step_with_jac_rows(fj, x, us[k], h)
        x = wrap_angles_rows(x, angle_indices)
        As.append(pack_mat(A))
        Bs.append(torch.stack(B))
    Jx = beye(sd, like.dtype, like.device).expand(sd, sd, M)
    cols = []
    for k in range(T):
        Jx = bmat(As[k], Jx)
        cols = [bmv(As[k], c) for c in cols]
        cols.append(Bs[k])
    return torch.stack(x), Jx, torch.stack(cols, dim=1)
