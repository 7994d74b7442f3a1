"""System identification through the MPC controller (the port of
``examples/sysid.py``).

A plant whose pole mass and length differ from the controller's model: the
controller's planned control windows are recorded on the true plant (cold
solves from eight excitation states), and the true ``m_1`` and ``l_1`` are
recovered by gradient descent on the plan-matching loss, with gradients
through the controller's own solve (``make_differentiable_solve``, the
``"ift"`` method). Adam at a learning rate of 5e-3 (``torch.optim.Adam`` in
place of the example's optax), f64, 120 steps from ``(0.10, 0.25)``; success
is an absolute error below 5e-3 on both.

The problem, loss and fitting loop are functions (``make_mpc_for``,
``excitation_states``, ``make_plans``, ``make_loss``, ``fit``), so that a
test or a smoke run can drive the same path at another size.

Usage, from the repository root:
    python3 -m cartpole_tpu_torch.tools.sysid [--device cpu] [--steps N]
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from .. import OptimizationParams, default_single_params, make_mpc
from ..diff import make_differentiable_solve

FIT_FIELDS = ("m_1", "l_1")
TRUE_VALUES = (0.16, 0.31)
#: The library's defaults: the wrong plant the fit starts from.
INITIAL_VALUES = (0.10, 0.25)
LEARNING_RATE = 5e-3
STEPS = 120
TOLERANCE = 5e-3


def make_mpc_for(window_length: int = 20):
    """The example's deeply converged controller (spacing 5, 20 GN
    iterations, no sinusoidal cold-start kick)."""
    return make_mpc(OptimizationParams(
        max_iterations=20, window_length=window_length, state_spacing=5,
        u_guess_sinusoid_amplitude=0.0))


def excitation_states(n: int = 8, seed: int = 3) -> np.ndarray:
    """Near-upright states with fast swings, ``(n, 4)``: tip mass is only
    identifiable from plans where inertia does real work."""
    rng = np.random.RandomState(seed)
    xs = np.tile(np.array([0.0, np.pi / 2, 0.0, 0.0]), (n, 1))
    xs[:, 0] += rng.uniform(-0.3, 0.3, n)
    xs[:, 1] += rng.uniform(-0.2, 0.2, n)
    xs[:, 2] += rng.uniform(-1.0, 1.0, n)
    xs[:, 3] += rng.uniform(-2.5, 2.5, n)
    return xs


def with_fit(base, v):
    """``base`` with the fitted fields set from ``v`` ``(2,)``."""
    return dataclasses.replace(
        base, **{f: v[i] for i, f in enumerate(FIT_FIELDS)})


def make_plans(mpc, xs):
    """``plans(dp) -> (n, window_length)``: the cold solves' control
    windows from each of ``xs`` ``(n, 4)``, batched by ``torch.func.vmap``
    and differentiable in ``dp`` (the ``"ift"`` backward)."""
    solve = make_differentiable_solve(mpc)
    cold = mpc.init_state(xs.dtype, xs.device)
    u_start = mpc.spec.u_start

    def plans(dp):
        return torch.func.vmap(
            lambda x: solve(x, dp, 0.0, cold)[u_start:])(xs)

    return plans


def make_loss(plans, base, u_data):
    """``loss(v)``: the mean squared plan mismatch with ``v`` the fitted
    fields."""
    def loss(v):
        return torch.mean((plans(with_fit(base, v)) - u_data) ** 2)

    return loss


def fit(loss, v0, steps: int, lr: float = LEARNING_RATE, log=None):
    """``steps`` Adam steps on ``loss`` from ``v0``; returns the fitted
    ``v`` and each step's loss (before its update). ``log(i, loss, v)`` is
    called after every step."""
    v = v0.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([v], lr=lr)
    losses = []
    for i in range(steps):
        g, val = torch.func.grad_and_value(loss)(v.detach())
        v.grad = g
        opt.step()
        losses.append(float(val))
        if log is not None:
            log(i, losses[-1], v.detach())
    return v.detach(), losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    f64 = torch.float64
    t_start = time.perf_counter()

    mpc = make_mpc_for()
    base = default_single_params(f64, device=dev)
    true_dp = with_fit(base, torch.tensor(TRUE_VALUES, dtype=f64, device=dev))
    xs = torch.as_tensor(excitation_states(), dtype=f64, device=dev)
    plans = make_plans(mpc, xs)
    with torch.no_grad():
        u_data = plans(true_dp)
    loss = make_loss(plans, base, u_data)
    print(f"true params:    m_1={TRUE_VALUES[0]:.4f}  l_1={TRUE_VALUES[1]:.4f}"
          f"  (device {dev}"
          + (f", {torch.cuda.get_device_name(dev)}" if dev.type == "cuda"
             else "") + ")", flush=True)
    v0 = torch.tensor(INITIAL_VALUES, dtype=f64, device=dev)
    print(f"initial guess:  m_1={INITIAL_VALUES[0]:.4f}  "
          f"l_1={INITIAL_VALUES[1]:.4f}", flush=True)

    def log(i, val, v):
        if i % 20 == 0 or i == args.steps - 1:
            secs = time.perf_counter() - t_start
            print(f"  step {i:3d}: loss {val:10.4e}  m_1={float(v[0]):.4f}  "
                  f"l_1={float(v[1]):.4f}  ({secs:.1f} s)", flush=True)

    v, _ = fit(loss, v0, args.steps, log=log)
    err = np.abs(v.cpu().numpy() - np.array(TRUE_VALUES))
    secs = time.perf_counter() - t_start
    print(f"recovered:      m_1={float(v[0]):.6f}  l_1={float(v[1]):.6f}  "
          f"(abs err {err[0]:.2e}, {err[1]:.2e}); {args.steps} steps in "
          f"{secs:.1f} s", flush=True)
    if err.max() >= TOLERANCE:
        print(f"sysid did not converge: abs err >= {TOLERANCE:g}",
              file=sys.stderr)
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
