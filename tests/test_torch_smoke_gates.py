"""Gates of ``chip_smoke.py`` that need no card, on made-up results.

``floor_ok`` (a kernel or a path against the plain version's agreement
with itself after a one-ulp nudge), ``check_upright_curve`` (the double
pole's upright share tick by tick against the JAX package's, from the
committed ``double_upright_jax_cpu.json``), the bit-for-bit gate of a
replayed closed loop against the eager tick function, the memory gate
over the double's chunks and the bit-for-bit gate of a replayed gradient
against the eager one (``same_bits``) accept what lies inside their bounds
and refuse what lies outside.
"""

import json
import math
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
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


#: The witnesses of the double's upright curve and the schedules they
#: ran: the smoke's (bench.py's whole 250-tick schedule), and the shortened
#: 10 + 5 ticks the smoke ran before its tick was a CUDA-graph replay.
WITNESSES = {
    "smoke": (cs.UPRIGHT_WITNESS, cs.DOUBLE_SCHEDULE),
    "switch": (os.path.join(REPO, "double_upright_switch_jax_cpu.json"),
               ((10, {"u_derivative_cost_weight": 0.8}), (5, None))),
}


@pytest.mark.parametrize("which", sorted(WITNESSES))
def test_upright_witness_matches_the_smoke_schedule(which):
    path, schedule = WITNESSES[which]
    w = cs.upright_witness(path, schedule)
    ticks = sum(n for n, _ in schedule)
    assert w["ticks"] >= ticks
    assert len(w["upright_by_tick"]) == w["ticks"] + 1
    if which == "smoke":
        assert max(cs.UPRIGHT_CHECKPOINTS) == ticks
        assert cs.DOUBLE_SCHEDULE == (
            (50, {"u_derivative_cost_weight": 0.8}), (200, None))
    assert w["n_failed"] == 0 and w["finite"]
    assert all(0.0 <= p <= 1.0 for p in w["upright_by_tick"])


def test_upright_witness_refuses_another_schedule():
    with pytest.raises(SystemExit, match="another schedule"):
        cs.upright_witness(*WITNESSES["switch"][:1], cs.DOUBLE_SCHEDULE)


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


# ------------------------------------------------ the graphed lanes loop
def _eager(seed=0, B=4, T=5):
    rng = np.random.RandomState(seed)
    return dict(
        states=torch.as_tensor(rng.normal(size=(B, T, 6)), dtype=torch.float32),
        controls=torch.as_tensor(rng.normal(size=(B, T)), dtype=torch.float32),
        termination_states=torch.as_tensor(rng.randint(0, 3, (B, T)),
                                           dtype=torch.int32),
        solver_iterations=torch.as_tensor(rng.randint(1, 9, (B, T)),
                                          dtype=torch.int32))


def _loop(eager, extra=3):
    """A closed loop's result whose first ticks are ``eager``'s, and
    ``extra`` more."""
    def longer(t):
        tail = torch.zeros_like(t[:, :1]).expand(
            (t.shape[0], extra) + tuple(t.shape[2:]))
        return torch.cat([t, tail], dim=1)

    return types.SimpleNamespace(**{k: longer(v) for k, v in eager.items()})


def _nudge(t):
    """One ulp up in the last entry of a float tensor."""
    t = t.clone()
    flat = t.view(-1)
    flat[-1] = torch.nextafter(flat[-1], torch.tensor(math.inf))
    return t


@pytest.mark.parametrize("spoil,bad", [
    (None, []),
    ("states", ["states"]),
    ("controls", ["controls"]),
    ("termination_states", ["termination_states"]),
    ("solver_iterations", ["solver_iterations"]),
    ("nan", []),
])
def test_bitwise_gate(spoil, bad):
    eager = _eager()
    res = _loop(eager)
    if spoil == "nan":
        # The same NaN in both: equal bits pass.
        eager["controls"][0, 0] = math.nan
        res.controls[0, 0] = math.nan
    elif spoil in ("states", "controls"):
        setattr(res, spoil, torch.cat([_nudge(getattr(res, spoil)[:, :5]),
                                       getattr(res, spoil)[:, 5:]], dim=1))
    elif spoil:
        getattr(res, spoil)[1, 2] += 1
    assert cs.bits_differ(eager, res) == bad
    if bad:
        with pytest.raises(SystemExit, match="departs"):
            cs.check_bitwise("made up", eager, res, "cpu")
    else:
        cs.check_bitwise("made up", eager, res, "cpu")


def test_bitwise_gate_reads_only_the_first_ticks():
    eager = _eager()
    res = _loop(eager)
    res.states[:, 5:] += 1.0
    assert cs.bits_differ(eager, res) == []


@pytest.mark.parametrize("values,ref,ok", [
    ([100, 120, 130, 130, 130, 130, 130], 3, True),   # flat
    ([100, 120, 130, 130, 129, 128, 128], 3, True),   # falls
    ([100, 120, 130, 130, 131, 132, 133], 3, False),  # grows a chunk
    ([100, 120, 130, 130, 130, 130, 131], 3, False),  # the last is above
])
def test_memory_gate(values, ref, ok):
    assert cs.memory_flat(values, ref) is ok


def test_held_bytes_counts_each_storage_once():
    a = torch.zeros(10, dtype=torch.float32)
    b = torch.zeros(3, dtype=torch.int64)
    assert cs.held_bytes([(a, a[2:], b)]) == 40 + 24
    assert cs.held_bytes([(a,), (a.view(2, 5).T,)]) == 40
    # The allocator's block of a storage where it has one.
    blocks = {a.untyped_storage().data_ptr(): 512}
    assert cs.held_bytes([(a, a[2:], b)], blocks) == 512 + 24


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


@pytest.mark.parametrize("spoil,same", [
    (None, True),
    ("ulp", False),          # one ulp off in one entry
    ("signed_zero", False),  # -0.0 for 0.0: equal values, other bits
    ("nan", True),           # the same NaN in both
    ("shape", False),        # the same values, another shape
    ("length", False),       # an output missing
])
def test_diff_graph_bitwise_gate(spoil, same):
    """``[diff-graph]``'s gate: a replayed gradient against the eager one
    on the same inputs, (dL/dx, dL/dm_1) in f32."""
    eager = (torch.tensor([441358.125, -205408.78125, 0.0, -25362.283]),
             torch.tensor(-4412.3057))
    replay = tuple(t.clone() for t in eager)
    if spoil == "ulp":
        replay[0][1] = torch.nextafter(replay[0][1], torch.tensor(0.0))
    elif spoil == "signed_zero":
        replay[0][2] = -0.0
    elif spoil == "nan":
        eager[0][3] = replay[0][3] = float("nan")
    elif spoil == "shape":
        replay = (replay[0].reshape(2, 2), replay[1])
    elif spoil == "length":
        replay = replay[:1]
    assert cs.same_bits(replay, eager) is same


# ------------------------------- the [interactive] and [triple-swingup] gates
def _interactive_run(w, spoil=None):
    """A scripted run's solve log (200 entries) and printed final state
    that reproduce the witness ``w``; ``spoil`` moves one of them."""
    entries = [None] * cs.INTERACTIVE_CHECK_TICKS[-1]
    for n, x, u, code in zip(w["ticks"], w["states"], w["u0"],
                             w["termination_states"]):
        entries[n - 1] = {
            "initial_state": {"b_x": x[0], "th_1": x[1], "b_x_dot": x[2],
                              "th_1_dot": x[3]},
            "u": [u, 0.0], "solver_outputs": {"termination_state": code}}
    printed = list(w["final_state_printed"])
    entry = entries[w["ticks"][-6] - 1]  # tick 150
    if spoil == "state":
        entry["initial_state"]["th_1"] += 2e-5
    elif spoil == "u":
        entry["u"][0] -= 2e-4
    elif spoil == "code":
        entry["solver_outputs"]["termination_state"] = "MAX_LAMBDA"
    elif spoil == "printed":
        printed[1] += 3e-4
    elif spoil == "short":
        entries.pop()
    return entries, printed


def test_interactive_witness_is_the_cli_run():
    w = cs.interactive_witness()
    assert w["ticks"] == list(range(10, 201, 10))
    assert set(cs.INTERACTIVE_CHECK_TICKS) <= set(w["ticks"])
    assert w["ticks"][-6] == 150
    p = w["params"]
    assert (p["window_length"], p["state_spacing"], p["max_iterations"]) == \
        (40, 10, 8)
    assert p == json.loads(pt.OptimizationParams().to_json())
    # swung up by tick 100; the poke before tick 101 knocks the pole
    # 0.3 rad or more off upright over ticks 110-130
    th = np.array(w["states"])[:, 1] - math.pi / 2
    assert abs(th[9]) < 0.05 and np.abs(th[10:13]).max() > 0.3


@pytest.mark.parametrize("spoil,ok", [
    (None, True), ("state", False), ("u", False), ("code", False),
    ("printed", False), ("short", False)])
def test_interactive_gate(spoil, ok):
    w = cs.interactive_witness()
    entries, printed = _interactive_run(w, spoil)
    assert cs.interactive_gate(entries, printed, w)["ok"] is ok


def test_triple_tracked_witness_is_the_reference_test():
    w = cs.triple_tracked_witness()
    assert w["replay_ticks"] == 240
    assert len(w["termination_states"]) == cs.TRIPLE_CATCH_TICKS
    params = pt.OptimizationParams(**cs.TRIPLE_CATCH_KWARGS)
    assert w["catch_params"] == json.loads(params.to_json())
    g = cs.triple_tracked_gate(np.array(w["x_mid"]), np.array(w["x_plan"]),
                               np.array(w["termination_states"]),
                               np.array(w["final_state"]))
    assert g["ok"], g


@pytest.mark.parametrize("spoil,check", [
    ("mid", "mid_swing_on_plan"), ("code", "no_failed_solve"),
    ("angle", "final_upright"), ("velocity", "final_at_rest")])
def test_triple_tracked_gate_refuses_each_fault(spoil, check):
    w = cs.triple_tracked_witness()
    x_mid, x_plan = np.array(w["x_mid"]), np.array(w["x_plan"])
    codes, xf = np.array(w["termination_states"]), np.array(w["final_state"])
    if spoil == "mid":
        x_mid[6] += 0.6
    elif spoil == "code":
        codes[40] = 4
    elif spoil == "angle":
        xf[3] += 2e-2
    else:
        xf[7] = 0.2
    g = cs.triple_tracked_gate(x_mid, x_plan, codes, xf)
    assert not g["ok"] and not g[check]
    assert sum(not g[k] for k in ("mid_swing_on_plan", "no_failed_solve",
                                  "final_upright", "final_at_rest")) == 1
