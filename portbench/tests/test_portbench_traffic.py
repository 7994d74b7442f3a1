"""The traffic generator: every draw reproduces from its seed, and the
amount of work never depends on the seed."""

import json
import math
import os

import numpy as np
import pytest

from conftest import ROOT
from portbench import traffic

MIXES = {n[:-5]: json.load(open(os.path.join(ROOT, "portbench", "traffic",
                                             n)))
         for n in sorted(os.listdir(os.path.join(ROOT, "portbench",
                                                 "traffic")))}
FLEETS = [k for k, v in MIXES.items() if v["driver"] == "lanes_fleet"]
BIG = 2**31 + 12345


@pytest.mark.parametrize("mix", FLEETS)
@pytest.mark.parametrize("sd, angles", [(4, (1,)), (6, (1, 2))])
def test_episode_reproduces_from_seed(mix, sd, angles):
    t = dict(MIXES[mix], batch=32)
    a = traffic.episode(t, sd, angles, BIG, 3)
    b = traffic.episode(t, sd, angles, BIG, 3)
    c = traffic.episode(t, sd, angles, BIG + 1, 3)
    d = traffic.episode(t, sd, angles, BIG, 4)
    np.testing.assert_array_equal(a[0], b[0])
    assert not np.array_equal(a[0], c[0]) and not np.array_equal(a[0], d[0])
    assert a[0].shape == c[0].shape == (32, sd)
    assert sorted(a[1]) == sorted(c[1]) == sorted(t.get("grid", {}))
    for k in a[1]:
        np.testing.assert_array_equal(a[1][k], b[1][k])
        lo, hi = t["grid"][k]
        assert a[1][k].shape == (32,)
        assert np.all((a[1][k] >= lo) & (a[1][k] <= hi))


@pytest.mark.parametrize("mix", FLEETS)
def test_states_stay_in_their_box(mix):
    t = dict(MIXES[mix], batch=500)
    hw = list(t["start"]["half_width"])
    sd, angles = (6, (1, 2)) if len(hw) > 2 else (4, (1,))
    x, _ = traffic.episode(t, sd, angles, 7, 0)
    center = np.zeros(sd)
    center[list(angles)] = {"hanging": -math.pi / 2,
                            "upright": math.pi / 2}[t["start"]["center"]]
    hw = np.array(hw + [0.0] * (sd - len(hw)))
    assert np.all(np.abs(x - center) <= hw)
    assert np.all((x - center)[:, hw == 0.0] == 0.0)


def test_warm_draw_is_its_own_stream():
    t = dict(MIXES[FLEETS[0]], batch=8)
    warm, _ = traffic.episode(t, 4, (1,), 5, -1)
    first, _ = traffic.episode(t, 4, (1,), 5, 0)
    assert not np.array_equal(warm, first)


def test_sample_reproduces_and_is_distinct():
    a = traffic.sample(4096, 64, BIG, 2)
    np.testing.assert_array_equal(a, traffic.sample(4096, 64, BIG, 2))
    assert len(set(a.tolist())) == 64 and np.all(np.diff(a) > 0)
    assert len(traffic.sample(10, 64, 1, 0)) == 10
