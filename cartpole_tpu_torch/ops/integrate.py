"""Angle wrap and the plant's substep schedule (counterpart of
``cartpole_tpu/ops/integrate.py:34-43,177``)."""

from __future__ import annotations

import math

import torch

__all__ = ["mod_pi", "split_substeps"]

_TWO_PI = 2.0 * math.pi


def mod_pi(angle):
    """Wrap an angle to ``(-pi, pi]``: ``mod_pi(pi) == mod_pi(-pi) == pi``.

    ``torch.remainder`` takes the sign of the divisor, as ``jnp.mod`` does,
    so ``pi - remainder(pi - angle, 2 pi)`` maps exactly onto ``(-pi, pi]``.
    """
    return math.pi - torch.remainder(math.pi - angle, _TWO_PI)


def split_substeps(dt: float, internal_dt: float = 1.0e-3):
    """Static substep schedule for the plant integrator: ``(n_full,
    remainder)`` such that ``dt = n_full * internal_dt + remainder`` with
    ``remainder`` dropped below 1e-12 (``simulator.cc:17-23`` arithmetic)."""
    n_full = int(dt / internal_dt)
    remainder = dt - n_full * internal_dt
    if remainder <= 1e-12:
        remainder = 0.0
    return n_full, remainder
