"""User-poke force model — the interactive-demo disturbance semantics
(the port's copy of ``cartpole_tpu/mpc/poke.py``: numpy only; the
dynamics params' fields may be Python numbers or 0-d tensors).

Capability parity with the reference web app's mouse pokes
(the original project's ``viz/src/application.ts:461-489``):

* a click applies a force at the clicked mass (base or pole tip) with
  magnitude **10x that mass** and direction ``(-cos(angle), sin(angle))``
  (the canvas y-flip is part of the published behavior);
* the force decays every frame by the Euler-discretized exponential
  ``f *= max(0, 1 - dt / tau)`` with ``tau = 0.1 s``, clipped to exactly 0
  below 1e-6 (``application.ts:461-472``).

The planner never sees these forces — they feed the plant only, exactly
like ``Application.stepControlAndSim`` (``application.ts:437-442``).
:func:`make_poke_schedule` precomputes the whole force history as a
``(num_steps, 2, 2)`` disturbance array for the batched/offline closed
loop (``run_closed_loop(..., disturbances=...)``);
:func:`decay_external_forces` / :func:`poke_force` are the live-loop
primitives of an interactive loop.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

__all__ = [
    "POKE_TIME_CONSTANT",
    "POKE_FORCE_SCALE",
    "poke_force",
    "decay_external_forces",
    "make_poke_schedule",
]

POKE_TIME_CONSTANT = 0.1  # seconds (application.ts:462)
POKE_FORCE_SCALE = 10.0  # x the clicked mass (application.ts:480-481)
_CLIP = 1.0e-6  # forces below this snap to zero (application.ts:463-465)


def poke_force(mass_index: int, incident_angle: float, dynamics_params):
    """Force vector of one click: 10x the clicked mass, direction from the
    incident angle (``application.ts:474-489``).

    ``mass_index``: 0 = base/cart, 1 = first link mass, 2 = second link
    mass (double pole). Returns ``(fx, fy)``.
    """
    masses = [dynamics_params.m_b, dynamics_params.m_1]
    if hasattr(dynamics_params, "m_2"):
        masses.append(dynamics_params.m_2)
    mag = POKE_FORCE_SCALE * float(masses[mass_index])
    return (
        -math.cos(incident_angle) * mag,
        math.sin(incident_angle) * mag,
    )


def decay_external_forces(forces, dt: float):
    """One decay step ``f * max(0, 1 - dt/tau)`` with the 1e-6 zero snap.

    ``forces``: array-like ``(..., 2)`` (numpy in the live loop).
    """
    forces = np.asarray(forces, float)
    scale = max(0.0, 1.0 - dt / POKE_TIME_CONSTANT)
    out = forces * scale
    out[np.abs(out) < _CLIP] = 0.0
    return out


def make_poke_schedule(
    num_steps: int,
    dt: float,
    pokes: Sequence[Tuple[int, int, float]],
    dynamics_params,
):
    """Precompute the decaying-poke disturbance history.

    Args:
      num_steps: closed-loop ticks.
      dt: tick duration (``control_dt``).
      pokes: ``(tick, mass_index, incident_angle)`` triples; a poke
        REPLACES the force at that mass (``application.ts:485-488``).
      dynamics_params: plant params (for the 10x mass scaling).

    Returns:
      ``(num_steps, 2, 2)`` float array: ``[:, 0]`` force at the base,
      ``[:, 1]`` at the pole mass — feed to
      ``run_closed_loop(..., disturbances=...)`` (batch by tiling a
      leading axis).
    """
    by_tick = {}
    for tick, mass_index, angle in pokes:
        if not 0 <= mass_index <= 1:
            raise ValueError(f"mass_index must be 0 or 1, got {mass_index}")
        if not 0 <= int(tick) < num_steps:
            raise ValueError(
                f"poke tick {tick} outside [0, {num_steps}) — it would be "
                "silently dropped from the schedule"
            )
        by_tick.setdefault(int(tick), []).append((mass_index, angle))

    forces = np.zeros((2, 2))
    out = np.zeros((num_steps, 2, 2))
    for t in range(num_steps):
        for mass_index, angle in by_tick.get(t, ()):
            forces[mass_index] = poke_force(
                mass_index, angle, dynamics_params
            )
        out[t] = forces
        forces = decay_external_forces(forces, dt)
    return out
