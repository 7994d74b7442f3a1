"""The one traffic generator: every mix is a data file of parameters in
``traffic/``, and everything random is drawn here from the run's seed.

A fleet episode draws its plants' initial states (and, for a parameter
grid, each plant's dynamics parameters) from ``(seed, episode)``. The
sizes and the amount of work never depend on the seed: only the values
drawn do.
"""

from __future__ import annotations

import math

import numpy as np

#: Keys of the streams drawn from one seed, so that they never overlap.
EPISODE, WARM, SAMPLE, PICK = 0, 1, 2, 4


def rng(seed: int, *keys: int) -> np.random.Generator:
    """The generator of stream ``keys`` of ``seed`` (any whole number)."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2**64, *keys]))


def initial_states(start: dict, state_dim: int, angle_indices, n: int,
                   gen: np.random.Generator) -> np.ndarray:
    """``(n, state_dim)`` plant states: every link hanging (angle -pi/2)
    or upright (+pi/2) at rest, plus a uniform draw of ``+-half_width[i]``
    on coordinate ``i``."""
    center = np.zeros(state_dim)
    angle = {"hanging": -math.pi / 2, "upright": math.pi / 2}[
        start["center"]]
    center[list(angle_indices)] = angle
    half = np.zeros(state_dim)
    hw = start["half_width"]
    half[:len(hw)] = hw
    return center + gen.uniform(-1.0, 1.0, (n, state_dim)) * half


def dynamics_grid(grid: dict, n: int, gen: np.random.Generator) -> dict:
    """Per-plant dynamics parameters: field -> ``(n,)`` uniform draws over
    ``[low, high]``, in the order the file lists them."""
    return {k: gen.uniform(lo, hi, n) for k, (lo, hi) in grid.items()}


def episode(traffic: dict, state_dim: int, angle_indices, seed: int,
            index: int, batch: int | None = None):
    """``(x0s, grid)`` of fleet episode ``index`` (``WARM`` draws the
    set-up's): ``grid`` is ``{}`` unless the mix is a parameter grid."""
    n = batch or traffic["batch"]
    gen = rng(seed, EPISODE, index) if index >= 0 else rng(seed, WARM)
    x0s = initial_states(traffic["start"], state_dim, angle_indices, n, gen)
    grid = dynamics_grid(traffic.get("grid", {}), n, gen)
    return x0s, grid


def sample(n: int, k: int, seed: int, *keys: int) -> np.ndarray:
    """Sorted indices of ``min(n, k)`` of ``range(n)``, drawn without
    replacement from stream ``(SAMPLE, *keys)`` of ``seed``."""
    return np.sort(rng(seed, SAMPLE, *keys).choice(n, min(n, k),
                                                   replace=False))
