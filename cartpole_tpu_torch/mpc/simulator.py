"""Plant simulator (counterpart of ``cartpole_tpu/mpc/simulator.py``).

The plant integrates the same dynamics model as the planner at fixed 1 ms
RK4 substeps (1 kHz, ``simulator.cc:17-23``) whatever the caller's step,
wraps the angles after each substep, and takes external forces at the base
and the link masses that the planner never sees. :func:`simulator_step` is
a function of one state ``(sd,)`` (batch it with ``torch.func.vmap``);
:class:`Simulator` is the stateful wrapper of the reference's class.
"""

from __future__ import annotations

import math

import torch

from ..models.base import CartPoleModel, SINGLE_CARTPOLE
from ..ops.integrate import substep_rollout

__all__ = ["simulator_step", "Simulator", "DEFAULT_INTERNAL_DT"]

DEFAULT_INTERNAL_DT = 1.0e-3  # simulator.cc:18


def simulator_step(dynamics_params, x, dt: float, u, f_base=None,
                   f_mass=None, model: CartPoleModel = SINGLE_CARTPOLE,
                   internal_dt: float = DEFAULT_INTERNAL_DT, f_mass_2=None):
    """Advance the plant state ``x`` ``(sd,)`` by ``dt`` under the constant
    control ``u``, with optional external forces ``(fx, fy)`` at the base,
    the first link mass and (double and triple) the second."""
    if dt < 0:
        raise ValueError("dt must be >= 0")

    def f(x_, u_):
        if f_mass_2 is not None:
            return model.dynamics(dynamics_params, x_, u_, f_base, f_mass,
                                  f_mass_2)
        return model.dynamics(dynamics_params, x_, u_, f_base, f_mass)

    return substep_rollout(f, x, u, dt, internal_dt, model.angle_indices)


class Simulator:
    """Stateful host-side wrapper (API parity with the reference class).

    Starts with every pole hanging down (``simulator.hpp:28``): the angles
    at -pi/2, the rest 0, as f64 on ``device`` (the card unless the caller
    asks for the CPU)."""

    def __init__(self, model: CartPoleModel = SINGLE_CARTPOLE,
                 dtype=torch.float64, device="cuda"):
        self.model = model
        x0 = [0.0] * model.state_dim
        for a in model.angle_indices:
            x0[a] = -math.pi / 2
        self._state = torch.tensor(x0, dtype=dtype, device=device)

    def get_state(self):
        return self._state

    def set_state(self, x):
        self._state = torch.as_tensor(x, dtype=self._state.dtype,
                                      device=self._state.device)

    def step(self, dynamics_params, dt: float, u, f_base=None, f_mass=None,
             f_mass_2=None, internal_dt: float = DEFAULT_INTERNAL_DT):
        u = torch.as_tensor(u, dtype=self._state.dtype,
                            device=self._state.device)
        if not bool(torch.all(torch.isfinite(u))):
            raise ValueError(f"u = {u} is not finite")  # simulator.cc:14
        self._state = simulator_step(dynamics_params, self._state, dt, u,
                                     f_base, f_mass, self.model, internal_dt,
                                     f_mass_2)
        return self._state
