"""Tests of the benchmark harness. Those that need the card are marked
``chip`` and take the ``card`` fixture, which skips them without one; run
them on the card with ``python -m pytest portbench/tests -m chip``."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs the NVIDIA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the NVIDIA card (run with -m chip on it)")
    return "cuda"


#: A tiny size of every cell for the CPU: window 4, spacing 2, a few
#: plants and ticks. A 0.04 s window cannot swing a hanging pole up (the
#: solve keeps its guess), so the single's fleets start near upright here.
#: Episodes run past their ``start_ticks``, so that a fault after the
#: start has ticks to show in.
NEAR_UPRIGHT = {"center": "upright", "half_width": [0.3, 0.2]}
TINY = {
    "single.fleet4k": {
        "traffic": {"batch": 6, "episode_ticks": 8, "warm_ticks": 2,
                    "trace_ticks": 2, "start": NEAR_UPRIGHT},
        "check": {"sample_per_episode": 4, "start_ticks": 3}},
    "double.fleet4k": {
        "traffic": {"batch": 6, "episode_ticks": 8, "warm_ticks": 2,
                    "trace_ticks": 2},
        "check": {"sample_per_episode": 4, "start_ticks": 3}},
    "single.grid98k": {
        "traffic": {"batch": 6, "episode_ticks": 8, "warm_ticks": 2,
                    "trace_ticks": 2, "start": NEAR_UPRIGHT},
        "check": {"sample_per_episode": 4, "start_ticks": 3}},
}


def tiny(cell: str, dtype: str = "float64") -> dict:
    """The overrides that shrink ``cell`` for the CPU."""
    return {"config": {"dtype": dtype,
                       "optimization": {"window_length": 4,
                                        "state_spacing": 2}},
            **TINY[cell]}
