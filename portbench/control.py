"""The control of the correctness check: the plain reference put in the
program's place and computed one precision below the configuration's.

A float32 configuration's program runs its products at full float32
precision (TF32 off: ``full_f32_matmul``), so its control is the
reference in float32 with TF32 on. On the card, the control runs a whole
episode of the cell's batch in the program's place, and the plants a run
would keep are judged by the same numbers against the float64 reference;
the limits lie between the program's readings and the control's
(``PERF.md``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import traffic
from .drivers import lanes_fleet


@contextlib.contextmanager
def tf32():
    """TF32 products on the card for the duration, the reference's own
    full-precision guard switched off."""
    from .reference.mpc import lanes
    from .reference.ops import fused, solver

    mods = (solver, fused, lanes)
    saved = [m.full_f32_matmul for m in mods]
    matmul = torch.backends.cuda.matmul
    per_backend = hasattr(matmul, "fp32_precision")
    old = matmul.fp32_precision if per_backend else matmul.allow_tf32
    for m in mods:
        m.full_f32_matmul = contextlib.nullcontext
    if per_backend:
        matmul.fp32_precision = "tf32"
    else:
        matmul.allow_tf32 = True
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.full_f32_matmul = f
        if per_backend:
            matmul.fp32_precision = old
        else:
            matmul.allow_tf32 = old


def control_record(config: dict, traffic_spec: dict, spec: dict, seed: int,
                   device="cuda") -> dict:
    """The control of a fleet cell on episode 0 of ``seed``: the reference
    in float32 with TF32, in the program's place, runs the whole episode
    of the whole batch from the episode's states, its own plant steps
    included (on the card as replays of one CUDA graph). Returns the
    plants a run would keep, in a kept episode's layout."""
    from .reference.models import get_model

    model = get_model(config["model"])
    x0s, grid = traffic.episode(traffic_spec, model.state_dim,
                                model.angle_indices, seed, 0)
    with tf32():
        chain = lanes_fleet.reference_chain(
            config, np.broadcast_to(x0s[:, None], (
                x0s.shape[0], traffic_spec["episode_ticks"], x0s.shape[1])),
            grid, torch.float32, device, closed=True)
    rec = lanes_fleet.as_record(chain, x0s, grid)
    idx = traffic.sample(x0s.shape[0], spec["sample_per_episode"], seed, 0)
    return {k: ({f: a[idx] for f, a in v.items()} if k == "grid"
                else v[idx]) for k, v in rec.items()}


def fleet_control(config: dict, traffic_spec: dict, spec: dict, seed: int,
                  device="cuda") -> dict:
    """The compared numbers of the control (:func:`control_record`)."""
    rec = control_record(config, traffic_spec, spec, seed, device)
    return lanes_fleet.fleet_numbers(config, rec, spec["start_ticks"],
                                     device=device)
