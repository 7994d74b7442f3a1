"""Differentiable MPC (counterpart of ``cartpole_tpu/diff.py``): gradients
through one receding-horizon solve.

``make_differentiable_solve`` wraps one solve (``MPC.step``) in a
``torch.autograd.Function`` whose forward and ``setup_context`` are kept
apart, so it works under plain ``.backward()``, ``torch.func.grad`` and
``torch.func.vmap`` (its batching rule is generated). Differentiation is
with respect to ``(x_current, dynamics_params, set_point)``; the warm start
selects the local basin and gets a zero gradient.

Two backward methods, as in the reference:

* ``"ift"``: one adjoint solve of the clamp-fixed-point system at the
  solution, with the true Hessian of the Lagrangian. The solve returns
  ``z*`` minimizing ``1/2 ||r(z, θ)||²`` subject to ``c(z, θ) = 0``, with
  controls and cart positions clamped by retraction. With ``d`` the
  (unclipped) Gauss-Newton step and ``μ`` its multipliers, the limit point
  satisfies, as the damping goes to 0::

      E1 (n_z):  Hc d + g + Gᵀ μ = 0       (GN-step stationarity)
      E2 (n_c):  G d + c = 0               (linearized feasibility)
      E3 (n_z):  active_i ? z_i ∓ lim : d_i = 0

  At an interior solution ``d ≡ 0`` and this is the plain KKT implicit
  function theorem, exact at convergence; at a clamped, damping-stabilized
  stall no implicit system is exact (the reference's docstring measures
  20-40 % off finite differences) and the gradient through every clamped
  coordinate is 0. The Jacobian of the system is assembled from separable
  second derivatives: the cost's Hessian plus one ``(sd + spacing)²``
  Hessian per shooting segment, scattered into place. The adjoint system,
  ``2 n_z + n_c`` square, is solved at its own size (the reference pads it
  to a multiple of 16 for the TPU's batched LU; the port does not).
* ``"unrolled"``: the derivative of the fixed-trip solver itself, exact for
  the algorithm (clamps, line search and damping schedule included) at
  saturated stalls too. The reference contracts forward-mode Jacobians
  (``jacfwd`` over the solve: an XLA:CPU miscompile of the transposed
  program ruled out reverse mode there); the port takes one reverse pass,
  ``torch.func.vjp`` of the recomputed solve: one backward instead of
  ``n_θ`` forward passes.

Second derivatives are reverse over reverse (``jacrev`` of ``jacrev``):
torch's forward mode sends every operation between a dual number and a
constant through a Python decomposition, several times slower here. The
whole backward runs at full f32 matmul precision
(``ops/solver.py::full_f32_matmul``): under bf16 passes the reference's f32
``ift`` gradient on the TPU was O(1) wrong, and TF32 is the same risk on an
NVIDIA card. The multipliers come from the QR of the ridge-stacked factor,
never from its Gram matrix. Tensors follow ``x_current``'s device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import grad, jacrev, vjp, vmap

from .mpc.controller import MPCState
from .ops import solver
from .ops.solver import full_f32_matmul

__all__ = ["make_differentiable_solve"]


def make_differentiable_solve(mpc, bound_tol: float = 1e-6,
                              multiplier_ridge: float = 1e-12,
                              with_diagnostics: bool = False,
                              method: str = "ift"):
    """Build ``solve(x_current, dynamics_params, set_point, state) -> z``,
    differentiable with respect to ``(x_current, dynamics_params,
    set_point)``.

    ``mpc`` is the static controller (``make_mpc``); ``state`` is the
    warm-start ``MPCState`` (no gradient flows into it). ``z`` is the full
    decision vector: ``z[mpc.spec.u_start:]`` is the control window,
    ``z[:u_start]`` the shooting states. ``set_point`` is a float or a 0-d
    tensor. With ``with_diagnostics=True`` the solve returns ``(z, diag)``,
    ``diag = {"active": (dim,) bool, "n_active": int32,
    "termination_state": int32}``: a nonzero ``n_active`` says the solve
    sits at a clamp, where ``"ift"`` is best effort and ``"unrolled"`` is
    exact.

    Gradients are exact when the forward solve has converged (enough
    ``max_iterations``; f64 for gradient work) and the active set is
    locally constant; ``bound_tol`` decides which coordinates count as
    clamped. ``method`` is ``"ift"`` (one adjoint solve) or ``"unrolled"``
    (one reverse pass through the recomputed fixed-trip solve); the module
    docstring says when each is exact.
    """
    if method not in ("ift", "unrolled"):
        raise ValueError(f"unknown method {method!r}")
    spec = mpc.spec
    p = mpc.params
    params_type = mpc.model.params_type

    def _u_prev_continuity(state, dtype):
        # MPC._initial_guess: the u-derivative cost's continuity anchor is
        # the warm start's first control (0 cold).
        u_prev = state.previous_solution.to(dtype)[spec.u_start:]
        return torch.where(state.warm, u_prev[0], 0.0)

    def _limits(dtype, device):
        # spec._u_mask and spec._pos_mask, kept on the device by _consts.
        k = spec._consts(dtype, device)
        full = torch.full(k["u_mask"].shape, math.inf, dtype=dtype,
                          device=device)
        return torch.where(k["u_mask"], p.u_limit,
                           torch.where(k["pos_mask"], p.b_x_limit, full))

    def _active_mask(z):
        return torch.abs(z) >= _limits(z.dtype, z.device) - bound_tol

    def _forward(x, dp, sp, state):
        outputs, _new_state = mpc.step(state, x, dp, b_x_set_point=sp)
        z = outputs.solution
        active = _active_mask(z)
        return z, {"active": active,
                   "n_active": torch.sum(active, dtype=torch.int32),
                   "termination_state": outputs.solver.termination_state}

    # Static scatter map: segment s's local variables are (x_s, u_segment_s),
    # the only z-coordinates its defect touches nonlinearly; no coordinate
    # belongs to two segments.
    sd, k, n_seg = spec.state_dim, spec.spacing, spec.num_states - 1
    _idx = np.empty((n_seg, sd + k), np.int64)
    for _s in range(n_seg):
        _idx[_s, :sd] = np.arange(_s * sd, (_s + 1) * sd)
        _idx[_s, sd:] = spec.u_start + np.arange(_s * k, (_s + 1) * k)
    n_def = n_seg * sd

    def bwd_ift(wz, z, x, dp, sp, state):
        dtype, device = z.dtype, z.device
        nz = spec.dim
        u_prev = _u_prev_continuity(state, dtype)
        a_f = _active_mask(z).to(dtype)

        def cost(z_, sp_):
            r = spec.cost_residuals(z_, sp_, u_prev)
            return 0.5 * torch.sum(r * r)

        def cons(z_, x_, dp_, sp_):
            return spec.constraints(z_, x_, sp_, dp_)

        def static_cons(z_, x_, sp_):
            # Pin and terminal equality rows (dynamics-free; constraint rows
            # n_def..n_c in spec.constraints' order).
            xs_, _ = spec._split(z_)
            return spec._linear_eq_residuals(xs_, x_, sp_)

        g0 = grad(cost)(z, sp)
        c0 = cons(z, x, dp, sp)
        A = jacrev(cons)(z, x, dp, sp)              # G, (n_c, n_z)
        n_c = A.shape[0]
        Hc = jacrev(grad(cost))(z, sp)              # ∂g/∂z (a.e. constant)

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        # (d, μ) at z*: least squares of [Hc D_a, Gᵀ; G D_a, 0] (d̃, μ) =
        # (-g, -c), d = D_a d̃, by the QR of the ridge-stacked factor
        # [A_ls; √ridge I] (min ||A_ls y - b||² + ridge ||y||²), never its
        # Gram matrix, which would square the condition of the nearly
        # dependent terminal rows.
        A_ls = torch.cat([torch.cat([Hc * a_f, A.T], dim=1),
                          torch.cat([A * a_f, zeros(n_c, n_c)], dim=1)])
        b_ls = torch.cat([-g0, -c0])
        n_y = nz + n_c
        eye_y = torch.eye(n_y, dtype=dtype, device=device)
        Q, R = torch.linalg.qr(torch.cat([A_ls,
                                          math.sqrt(multiplier_ridge)
                                          * eye_y]))
        y = torch.linalg.solve_triangular(
            R, (Q.T @ torch.cat([b_ls, zeros(n_y)]))[:, None],
            upper=True)[:, 0]
        d = a_f * y[:nz]
        mu = y[nz:]

        # The system's Jacobian from separable second derivatives:
        #   ∂E1/∂z = Hc + Σ_s ∇²[μ_sᵀ seg_s]          (S(μ), scattered)
        #   ∂E2/∂z = G + Σ_s ∂/∂v[∂seg_s/∂v · d_s]    (W(d), scattered)
        # (pin and terminal rows are linear in z; Hc·d has no θ or z flow
        # a.e., every cost residual being linear a.e.).
        xs, useg = spec._split(z)
        vs = torch.cat([xs[:-1], useg], dim=1)          # (n_seg, sd+k)
        mu_def = mu[:n_def].reshape(n_seg, sd)
        idx = torch.as_tensor(_idx, device=device)
        d_v = d[idx]                                    # (n_seg, sd+k)

        def seg_out(v, dp_):
            return spec._segment_fn(dp_)(v[:sd], v[sd:])

        def seg_scalar(v, m_s, dp_):
            return torch.dot(m_s, seg_out(v, dp_))

        Hseg = vmap(jacrev(jacrev(seg_scalar)), in_dims=(0, 0, None))(
            vs, mu_def, dp)                             # (n_seg, sd+k, sd+k)
        Smu = zeros(nz, nz).index_put(
            (idx[:, :, None].expand_as(Hseg), idx[:, None, :].expand_as(Hseg)),
            Hseg, accumulate=True)

        def seg_w_rows(v, d_s, dp_):
            return jacrev(lambda vv: jacrev(seg_out)(vv, dp_) @ d_s)(v)

        Wseg = vmap(seg_w_rows, in_dims=(0, 0, None))(vs, d_v, dp)
        row_idx = torch.arange(n_def, device=device).reshape(n_seg, sd)
        W = zeros(n_c, nz).index_put(
            (row_idx[:, :, None].expand_as(Wseg),
             idx[:, None, :].expand_as(Wseg)), Wseg, accumulate=True)

        eye = torch.eye(nz, dtype=dtype, device=device)
        D_a = torch.diag(a_f)
        M = torch.cat([
            torch.cat([Hc + Smu, Hc, A.T], dim=1),
            torch.cat([A + W, A, zeros(n_c, n_c)], dim=1),
            torch.cat([D_a, eye - D_a, zeros(nz, n_c)], dim=1),
        ])
        lam = solver.solve(M.T, torch.cat([wz, zeros(n_c + nz)]))
        phi1 = lam[:nz]                 # E1 adjoint
        phi2 = lam[nz:nz + n_c]         # E2 adjoint (E3 is θ-free)

        # θ-gradients: -φᵀ ∂F/∂θ, the dynamics-free part (x and the set
        # point enter through the cost, pin and terminal rows) and the
        # per-segment part (the dynamics parameters enter through the RK4
        # chains). E2 contributes its value (φ2ᵀ c) and its step coupling
        # (φ2ᵀ ∂(G d)/∂θ); the static rows' G·d has constant coefficients.
        phi2_def = phi2[:n_def].reshape(n_seg, sd)
        phi2_lin = phi2[n_def:]
        nu_lin = mu[n_def:]
        phi1_v = phi1[idx]                              # (n_seg, sd+k)

        def phi_static(x_, sp_):
            def l_static(z_):
                return cost(z_, sp_) + torch.dot(
                    nu_lin, static_cons(z_, x_, sp_))

            dir_grad = torch.dot(grad(l_static)(z), phi1)
            return dir_grad + torch.dot(phi2_lin, static_cons(z, x_, sp_))

        def phi_dyn(dp_):
            def one(v, mu_s, p1_s, p2_s, d_s):
                x_end, seg_vjp = vjp(lambda vv: seg_out(vv, dp_), v)
                mixed = torch.dot(seg_vjp(mu_s)[0], p1_s)
                gd = torch.dot(seg_vjp(p2_s)[0], d_s)
                return mixed + gd + torch.dot(p2_s, x_end)

            return torch.sum(vmap(one)(vs, mu_def, phi1_v, phi2_def, d_v))

        gx, gsp = grad(phi_static, argnums=(0, 1))(x, sp)
        gdp = grad(phi_dyn)(dp)
        return -gx, -gsp, tuple(-g for g in gdp.as_tuple())

    def bwd_unrolled(wz, z, x, dp, sp, state):
        # One reverse pass through the recomputed fixed-trip solve.
        def f(x_, dp_, sp_):
            return _forward(x_, dp_, sp_, state)[0]

        _, f_vjp = vjp(f, x, dp, sp)
        gx, gdp, gsp = f_vjp(wz)
        return gx, gsp, gdp.as_tuple()

    backward_of = bwd_ift if method == "ift" else bwd_unrolled

    class _Solve(torch.autograd.Function):
        generate_vmap_rule = True

        @staticmethod
        def forward(x, sp, prev, warm, *dp_fields):
            z, diag = _forward(x, params_type(*dp_fields), sp,
                               MPCState(prev, warm))
            return (z, diag["active"], diag["n_active"],
                    diag["termination_state"])

        @staticmethod
        def setup_context(ctx, inputs, output):
            x, sp, prev, warm, *dp_fields = inputs
            z, active, n_active, term = output
            ctx.mark_non_differentiable(active, n_active, term)
            ctx.save_for_backward(z, x, sp, prev, warm, *dp_fields)

        @staticmethod
        def backward(ctx, wz, *_int_cotangents):
            z, x, sp, prev, warm, *dp_fields = ctx.saved_tensors
            # TF32 (or the TPU's bf16 passes) breaks the f32 adjoint
            # assembly by O(1), as it breaks the solver's factorizations.
            with full_f32_matmul():
                gx, gsp, gdp = backward_of(wz, z, x, params_type(*dp_fields),
                                           sp, MPCState(prev, warm))
            return (gx, gsp, torch.zeros_like(prev), None, *gdp)

    def solve(x_current, dynamics_params, set_point, state):
        def tensor(v):
            return (v if isinstance(v, torch.Tensor) else torch.as_tensor(
                v, dtype=x_current.dtype, device=x_current.device))

        z, active, n_active, term = _Solve.apply(
            x_current, tensor(set_point), state.previous_solution,
            state.warm, *(tensor(v) for v in dynamics_params.as_tuple()))
        if with_diagnostics:
            return z, {"active": active, "n_active": n_active,
                       "termination_state": term}
        return z

    return solve
