"""The correctness check on the card, at a size a test run holds (the real
widths, fewer plants and ticks): the check's reference as replays of one
CUDA graph gives what its eager ticks give; the reference in float32 with
TF32 put in the program's place fails the limits, and the program at the
same size passes them. ``readings.py`` reads the same at each cell's own
size (``PERF.md``)."""

import time

import numpy as np
import pytest
import torch

from portbench import control, harness, traffic
from portbench.drivers import lanes_fleet
from portbench.reference.models import get_model

SEEDS = (11, 12, 13)
FLEETS = ["single.fleet4k", "double.fleet4k", "single.grid98k"]


@pytest.mark.chip
@pytest.mark.parametrize("cell_name", FLEETS)
def test_reference_replay_matches_eager(card, cell_name):
    cell = harness.load_cell(cell_name)
    model = get_model(cell.config["model"])
    x0s, grid = traffic.episode(cell.traffic, model.state_dim,
                                model.angle_indices, 5, 0, batch=16)
    states = np.broadcast_to(x0s[:, None], (16, 6, model.state_dim))
    on_card = lanes_fleet.reference_chain(cell.config, states, grid,
                                          torch.float64, card, closed=True)
    on_host = lanes_fleet.reference_chain(cell.config, states, grid,
                                          torch.float64, "cpu", closed=True)
    for key, value in on_host.items():
        np.testing.assert_allclose(np.asarray(on_card[key], np.float64),
                                   np.asarray(value, np.float64), rtol=1e-9,
                                   atol=1e-9, err_msg=key)


@pytest.mark.chip
@pytest.mark.parametrize("cell_name", FLEETS)
def test_fleet_control_fails(card, cell_name):
    cell = harness.load_cell(cell_name)
    mix = dict(cell.traffic, batch=512, episode_ticks=50)
    for seed in SEEDS:
        numbers = control.fleet_control(cell.config, mix, cell.limits, seed,
                                        card)
        ok, checks = harness.verdict(numbers, cell.limits["limits"])
        assert not ok, checks


@pytest.mark.chip
@pytest.mark.parametrize("cell_name", ["single.fleet4k", "single.grid98k"])
def test_fleet_program_passes(card, cell_name):
    cell = harness.load_cell(cell_name)
    over = {"traffic": {"batch": 512, "episode_ticks": 50}}
    for seed in SEEDS:
        out = harness.run_cell(cell, seed, 0.01, False, card,
                               time.monotonic(), over)
        assert out["correct"], out["checks"]
