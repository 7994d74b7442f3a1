"""Kernel 1's count of operations and bytes (and a whole tick's): linear
in the batch, and a function of the shapes alone."""

import json
import os

import pytest

from conftest import ROOT
from portbench import count

CONFIGS = {n: json.load(open(os.path.join(ROOT, "portbench", "configs",
                                          n + ".json")))
           for n in ("single", "double")}
TRAFFIC = {n: json.load(open(os.path.join(ROOT, "portbench", "traffic",
                                          n + ".json")))
           for n in ("swingup4k", "grid98k")}


def small(name):
    c = dict(CONFIGS[name])
    c["optimization"] = dict(c["optimization"], window_length=10,
                             state_spacing=5)
    return c


@pytest.mark.parametrize("cost", [count.kernel1_cost, count.tick_cost])
@pytest.mark.parametrize("name, mix", [("single", "swingup4k"),
                                       ("single", "grid98k")])
def test_linear_in_batch(cost, name, mix):
    a = cost(small(name), TRAFFIC[mix], 1)
    b = cost(small(name), TRAFFIC[mix], 4096)
    assert a["flops"] > 0 and a["bytes"] > 0
    for k in ("flops", "bytes"):
        assert b[k] == pytest.approx(4096 * a[k], rel=1e-12)


def test_reads_shapes_only():
    """Other states, other parameters: the same count."""
    c = small("single")
    base = count.kernel1_cost(c, TRAFFIC["swingup4k"], 64)
    moved = dict(TRAFFIC["swingup4k"],
                 start={"center": "upright", "half_width": [0.1, 0.2]})
    assert count.kernel1_cost(c, moved, 64) == base
    heavier = dict(c, dynamics=dict(c["dynamics"], m_1=0.3))
    assert count.kernel1_cost(heavier, TRAFFIC["swingup4k"], 64) == base


def test_grows_with_the_window():
    c = small("single")
    longer = dict(c, optimization=dict(c["optimization"], window_length=20))
    assert (count.kernel1_cost(longer, TRAFFIC["swingup4k"], 1)["flops"]
            > count.kernel1_cost(c, TRAFFIC["swingup4k"], 1)["flops"])


def test_roofline_share():
    assert count.roofline_share(67e12, 0.0, 1.0) == pytest.approx(100.0)
    assert count.roofline_share(0.0, 3.35e12, 2.0) == pytest.approx(50.0)
