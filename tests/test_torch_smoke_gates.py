"""Gates of ``chip_smoke.py`` that need no card, on made-up results.

``floor_ok`` (a kernel or a path against the plain version's agreement
with itself after a one-ulp nudge) and ``check_upright_curve`` (the double
pole's upright share tick by tick against the JAX package's, from the
committed ``double_upright_jax_cpu.json``) accept what lies inside their
bounds and refuse what lies outside.
"""

import math
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
cs = pytest.importorskip("chip_smoke")
pt = pytest.importorskip("cartpole_tpu_torch")

FLOOR = dict(identical_fraction=0.946, rel_du=0.0024)


@pytest.mark.parametrize("ident,rel_du,ok", [
    (0.946, 0.0024, True),    # on the floor
    (0.927, 0.0047, True),    # 1.9 points and 1.96x off it
    (0.925, 0.0024, False),   # more than 2 points below
    (0.999, 0.0049, False),   # beyond twice the floor's rel_du
    (0.999, float("nan"), False),  # no agreeing instance
])
def test_floor_ok(ident, rel_du, ok):
    r = dict(identical_fraction=ident, rel_du=rel_du)
    assert cs.floor_ok(r, FLOOR) is ok


def test_floor_ok_keeps_the_strict_bound_below_it():
    tight = dict(identical_fraction=1.0, rel_du=1e-6)
    assert cs.floor_ok(dict(identical_fraction=1.0, rel_du=9e-4), tight)
    assert not cs.floor_ok(dict(identical_fraction=1.0, rel_du=2e-3), tight)


def test_upright_witness_matches_the_smoke_schedule():
    w = cs.upright_witness()
    ticks = sum(n for n, _ in cs.DOUBLE_SCHEDULE)
    assert w["ticks"] >= ticks
    assert len(w["upright_by_tick"]) == w["ticks"] + 1
    assert max(cs.UPRIGHT_CHECKPOINTS) == ticks
    assert w["n_failed"] == 0 and w["finite"]
    assert all(0.0 <= p <= 1.0 for p in w["upright_by_tick"])


def _result(shares, B, sd=6):
    """A closed-loop result whose upright share at tick t is shares[t]:
    the first round(share * B) instances upright, the rest hanging."""
    T = len(shares) - 1
    x = np.zeros((B, T + 1, sd))
    x[:, :, 1:3] = -math.pi / 2
    for t, p in enumerate(shares):
        x[:int(round(p * B)), t, 1:3] = math.pi / 2
    x = torch.as_tensor(x)
    return types.SimpleNamespace(states=x[:, :T], final_state=x[:, T])


@pytest.mark.parametrize("shift,ok", [(0.0, True), (-0.3, False)])
def test_check_upright_curve(shift, ok):
    w = cs.upright_witness()
    T = max(cs.UPRIGHT_CHECKPOINTS)
    shares = np.clip(np.array(w["upright_by_tick"][:T + 1]) + shift, 0, 1)
    res = _result(shares, 1024)
    if ok:
        cs.check_upright_curve(res, pt.DOUBLE_CARTPOLE, "cpu")
    else:
        with pytest.raises(SystemExit):
            cs.check_upright_curve(res, pt.DOUBLE_CARTPOLE, "cpu")
