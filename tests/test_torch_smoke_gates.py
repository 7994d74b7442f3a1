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


# ------------------------------------------------ the per-instance phases
def _swingup(T=250):
    """A made-up run that meets every swing-up gate."""
    codes = np.full(T, 2)
    tp = np.zeros((T, 4))
    tp[:, 1] = math.pi / 2
    tp[:21, 1] = 0.3  # warm-up ticks are not gated
    xf = np.array([0.01, math.pi / 2 + 5e-5, -5e-5, 5e-4])
    viol = np.full(T, 1e-7)
    viol[:21] = 1.0
    u = np.linspace(-280.0, 280.0, T)
    return codes, tp, xf, viol, u


def test_swingup_gate_accepts_a_good_run():
    g = cs.swingup_gate(*_swingup())
    assert g["ok"] and all(v for k, v in g.items() if isinstance(v, bool))


@pytest.mark.parametrize("spoil,check", [
    (lambda r: r[0].__setitem__(100, 3), "no_failed_solve"),
    (lambda r: r[0].__setitem__(7, 4), "no_failed_solve"),
    (lambda r: r[1].__setitem__((30, 1), math.pi / 2 + 2e-4),
     "terminal_upright_after_tick_20"),
    (lambda r: r[1].__setitem__((200, 3), -2e-4),
     "terminal_upright_after_tick_20"),
    (lambda r: r[2].__setitem__(1, math.pi / 2 - 2e-4), "final_upright"),
    (lambda r: r[2].__setitem__(3, 2e-3), "final_upright"),
    (lambda r: r[3].__setitem__(21, 2e-4), "violation_after_tick_20"),
    (lambda r: r[4].__setitem__(5, 300.5), "controls_within_limit"),
])
def test_swingup_gate_refuses_each_fault(spoil, check):
    run = list(_swingup())
    spoil(run)
    g = cs.swingup_gate(*run)
    assert not g[check] and not g["ok"]


def test_health_gate():
    codes, _, _, _, u = _swingup(100)
    assert cs.health_gate(codes, u)["ok"]
    assert not cs.health_gate(np.r_[codes, 3], np.r_[u, 0.0])["ok"]
    assert not cs.health_gate(codes, u * 1.1)["ok"]


@pytest.mark.parametrize("du,dx,ok", [
    (9e-5, 9e-6, True), (2e-4, 0.0, False), (0.0, 2e-5, False)])
def test_oracle_gate(du, dx, ok):
    rng = np.random.RandomState(0)
    u_ref, x_ref = rng.normal(0, 30, 100), rng.normal(0, 1, (100, 4))
    u, x = u_ref.copy(), x_ref.copy()
    u[50] += du
    x[60, 2] += dx
    g = cs.oracle_gate(u, x, u_ref, x_ref)
    assert g["ok"] is ok
    assert g["max_abs_du"] == pytest.approx(du, abs=1e-12)


@pytest.mark.parametrize("floor,r,ok,gate", [
    # path 2 meets the strict gate against itself: the strict gate holds
    (dict(identical_fraction=1.0, rel_du=1e-6),
     dict(identical_fraction=0.9995, rel_du=5e-4), True, "strict"),
    (dict(identical_fraction=1.0, rel_du=1e-6),
     dict(identical_fraction=0.998, rel_du=5e-4), False, "strict"),
    # path 2's own floor lies below it: the floor gate
    (dict(identical_fraction=0.996, rel_du=8e-6),
     dict(identical_fraction=0.985, rel_du=9e-4), True, "floor"),
    (dict(identical_fraction=0.996, rel_du=8e-6),
     dict(identical_fraction=0.97, rel_du=9e-4), False, "floor"),
])
def test_vmap_agreement_gate(floor, r, ok, gate):
    assert cs.vmap_agreement_ok(dict(r, path2_vs_nudged_path2=floor)) == (
        ok, gate)


def test_sweep_states_follow_the_cli():
    """cli.py's sweep: hanging poles, b_x and theta moved by up to 0.3,
    seed 0, in that order of draws."""
    x = cs.sweep_x0s(256)
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(x[:, 0], rng.uniform(-0.3, 0.3, 256))
    np.testing.assert_array_equal(x[:, 1],
                                  -math.pi / 2 + rng.uniform(-0.3, 0.3, 256))
    assert not x[:, 2:].any()
    assert cs.TICKS_SWINGUP == 250 and cs.TICKS_ORACLE == 100


# ------------------------------------------------------ the [diff] phases
def test_diff_witnesses_describe_the_probe_point():
    """The TPU run's finite differences and the JAX package's f64
    gradients are of the same point; the f32 gate passes the TPU's own
    gradients and the JAX package's f64 unrolled one."""
    w, w64 = cs.diff_witness(), cs.diff_f64_witness()
    fd = w["fd_f64_cpu"]
    assert w["pass"] and w["diagnostics"] == w64["diagnostics"]
    for method in ("ift", "unrolled"):
        assert cs.diff_gate(w[method]["g_x"], w[method]["g_m1"], fd)["ok"]
    g = cs.close_gate(w64["unrolled"]["g_x"] + [w64["unrolled"]["g_m1"]],
                      fd["g_x"] + [fd["g_m1"]], cs.DIFF_F64_RTOL,
                      cs.DIFF_F64_ATOL)
    assert g["ok"]


@pytest.mark.parametrize("scale,shift,ok", [
    (1.0, 0.0, True),          # the witness itself
    (1.04, 0.0, True),         # 4 % off everywhere: cos 1, rel 0.04
    (1.06, 0.0, False),        # 6 % off
    (1.0, 2e4, False),         # a shifted x component: rel 0.79 there
    (-1.0, 0.0, False),        # the sign flipped (cos -1)
])
def test_diff_gate(scale, shift, ok):
    fd = cs.diff_witness()["fd_f64_cpu"]
    g_x = np.asarray(fd["g_x"]) * scale
    g_x[3] += shift
    assert cs.diff_gate(g_x, fd["g_m1"] * scale, fd)["ok"] is ok


def test_close_gate():
    g = cs.close_gate([1.0, -2.0 * (1 + 1.5e-4)], [1.0, -2.0], 2e-4)
    assert g["ok"] and g["max_rel_err"] == pytest.approx(1.5e-4)
    assert not cs.close_gate([1.0, -2.0 * (1 + 3e-4)], [1.0, -2.0],
                             2e-4)["ok"]
    assert not cs.close_gate([1.0, float("nan")], [1.0, -2.0], 2e-4)["ok"]
