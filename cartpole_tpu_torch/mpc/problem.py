"""Static structure of the multiple-shooting MPC problem and the QR-Schur
helpers (counterpart of ``cartpole_tpu/mpc/problem.py:109-357``).

Decision vector layout matches the reference (``optimization.cc:24-37``)::

    z = [x(0), x(1), ..., x(N-1), u(0), ..., u(K-1)],  dim = N*sd + K

The static structure is plain numpy, built once per spec. The QR helpers
work on the column-list form: each column is a tensor whose leading axis is
the column's rows and whose trailing axes are the batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..models.base import CartPoleModel
from .config import OptimizationParams

__all__ = ["TerminalSpec", "MPCProblemSpec"]


def _mgs_qr(cols):
    """2-pass modified-Gram-Schmidt QR of a tall-skinny matrix given as a
    list of ``n`` columns, each ``(m, ...)``.

    Returns ``(qs, R)``: ``qs`` the orthonormal columns and ``R`` an
    ``n x n`` list-of-lists of per-instance scalars (upper triangular,
    ``R[i][j]`` set for ``i <= j``). Two passes restore orthogonality to
    ~eps ("twice is enough"); a relative floor on each pivot guards rank
    collapse (1e-6 in f32, 1e-14 in f64)."""
    cols = list(cols)
    n = len(cols)
    eps_rel = 1.0e-6 if cols[0].dtype == torch.float32 else 1.0e-14
    R = [[None] * n for _ in range(n)]
    qs = []
    for j in range(n):
        v = cols[j]
        orig_norm = torch.sqrt(torch.sum(v * v, dim=0))
        rj = [torch.zeros_like(orig_norm) for _ in range(j)]
        for _pass in range(2):
            for i in range(j):
                h = torch.sum(qs[i] * v, dim=0)
                v = v - h * qs[i]
                rj[i] = rj[i] + h
        nrm = torch.sqrt(torch.sum(v * v, dim=0))
        nrm = torch.maximum(nrm, eps_rel * orig_norm + 1.0e-30)
        for i in range(j):
            R[i][j] = rj[i]
        R[j][j] = nrm
        qs.append(v / nrm)
    return qs, R


def _tri_rt_solve(R, b):
    """Solve ``R^T y = b`` (forward substitution) for upper-triangular
    ``R`` from :func:`_mgs_qr`; ``b`` a length-``n`` sequence of rows."""
    n = len(R)
    y = [None] * n
    for i in range(n):
        acc = b[i]
        for k in range(i):
            acc = acc - R[k][i] * y[k]
        y[i] = acc / R[i][i]
    return y


def _tri_r_solve(R, b):
    """Solve ``R x = b`` (back substitution) for upper-triangular ``R``."""
    n = len(R)
    x = [None] * n
    for i in reversed(range(n)):
        acc = b[i]
        for k in range(i + 1, n):
            acc = acc - R[i][k] * x[k]
        x[i] = acc / R[i][i]
    return x


def _qr_gram_factor(cols):
    """Factor a tall-skinny matrix ``T`` (list of columns) and return
    ``solve(b)`` computing ``(T^T T)^{-1} b`` through the R factor of a
    2-pass MGS QR plus triangular substitutions — the Gram matrix is never
    formed (forming it squares cond(T) into the f32 entries)."""
    _qs, R = _mgs_qr(cols)

    def solve(b):
        return torch.stack(_tri_r_solve(R, _tri_rt_solve(R, b)))

    return solve


@dataclasses.dataclass(frozen=True)
class TerminalSpec:
    """One terminal-state objective: cost row (weight >= 0) or equality row."""

    coord: int  #: state coordinate index at the terminal shooting state.
    target: float  #: static target (ignored when is_setpoint).
    weight: float  #: residual weight (1.0 for equality rows).
    is_angle: bool  #: wrap the difference with mod_pi.
    is_setpoint: bool  #: target is the dynamic b_x set-point argument.


class MPCProblemSpec:
    """Precomputed static structure of the multiple-shooting NLS problem."""

    def __init__(self, params: OptimizationParams, model: CartPoleModel):
        self.params = params
        self.model = model
        sd = model.state_dim
        K = params.window_length
        spacing = params.state_spacing
        N = params.num_states

        self.state_dim = sd
        self.num_states = N
        self.window_length = K
        self.spacing = spacing
        self.u_start = N * sd
        self.dim = N * sd + K
        self.n_defect = (N - 1) * sd

        n_q = sd // 2
        # Terminal objective coordinates in reference order:
        # b_x, angle(s), b_x_dot, angle rate(s) (optimization.cc:236-267).
        coord_specs = [(0, 0.0, params.b_x_final_cost_weight, False, True)]
        for a in model.angle_indices:
            coord_specs.append(
                (a, math.pi / 2, params.th_final_cost_weight, True, False))
        coord_specs.append(
            (n_q, 0.0, params.b_x_dot_final_cost_weight, False, False))
        for a in model.angle_indices:
            coord_specs.append(
                (a + n_q, 0.0, params.th_dot_final_cost_weight, False, False))

        # Zero-weight rows are dropped; a negative weight makes the row an
        # equality constraint with unit weight (optimization.cc:236-267).
        self.terminal_costs: Tuple[TerminalSpec, ...] = tuple(
            TerminalSpec(c, t, w, ang, sp)
            for (c, t, w, ang, sp) in coord_specs if w > 0.0
        )
        self.terminal_eqs: Tuple[TerminalSpec, ...] = tuple(
            TerminalSpec(c, t, 1.0, ang, sp)
            for (c, t, w, ang, sp) in coord_specs if w < 0.0
        )
        self._build_static_structure()

    def _x_off(self, s: int) -> int:
        return s * self.state_dim

    def _build_static_structure(self):
        p, sd, N, K = (self.params, self.state_dim, self.num_states,
                       self.window_length)
        D, u0 = self.dim, self.u_start
        xN = self._x_off(N - 1)

        # Constant cost Jacobian (all cost residuals are linear in z).
        rows = []
        for spec in self.terminal_costs:
            row = np.zeros(D)
            row[xN + spec.coord] = spec.weight
            rows.append(row)
        if p.u_derivative_cost_weight > 0.0:
            w = p.u_derivative_cost_weight
            for k in range(K - 1):
                row = np.zeros(D)
                row[u0 + k] = w
                row[u0 + k + 1] = -w
                rows.append(row)
            row = np.zeros(D)  # continuity with previous iteration's u(0).
            row[u0] = w
            rows.append(row)
        if p.u_cost_weight > 0.0:
            for k in range(K):
                row = np.zeros(D)
                row[u0 + k] = p.u_cost_weight
                rows.append(row)
        self.n_res = len(rows)
        self._J_cost = np.stack(rows) if rows else np.zeros((0, D))

        # Constant Jacobian of the linear equality rows: initial-state pins
        # (optimization.cc:228-232) then terminal equalities.
        lin_rows = []
        for i in range(sd):
            row = np.zeros(D)
            row[i] = 1.0
            lin_rows.append(row)
        for spec in self.terminal_eqs:
            row = np.zeros(D)
            row[xN + spec.coord] = 1.0
            lin_rows.append(row)
        self._A_lin = np.stack(lin_rows)
        self.n_eq = self.n_defect + self._A_lin.shape[0]

        # u-only part of the cost Jacobian (the condensed path's static
        # Gram matrix is built from it).
        u_rows = []
        if p.u_derivative_cost_weight > 0.0:
            w = p.u_derivative_cost_weight
            for k in range(K - 1):
                row = np.zeros(K)
                row[k] = w
                row[k + 1] = -w
                u_rows.append(row)
            row = np.zeros(K)
            row[0] = w
            u_rows.append(row)
        if p.u_cost_weight > 0.0:
            for k in range(K):
                row = np.zeros(K)
                row[k] = p.u_cost_weight
                u_rows.append(row)
        self._J_cost_u = np.stack(u_rows) if u_rows else np.zeros((0, K))

        # Retraction masks (optimization.cc:309-329).
        angle_mask = np.zeros(D, bool)
        pos_mask = np.zeros(D, bool)
        u_mask = np.zeros(D, bool)
        for s in range(N):
            for a in self.model.angle_indices:
                angle_mask[self._x_off(s) + a] = True
            pos_mask[self._x_off(s)] = True
        u_mask[u0:] = True
        self._angle_mask = angle_mask
        self._pos_mask = pos_mask
        self._u_mask = u_mask
