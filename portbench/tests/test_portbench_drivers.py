"""Each driver through a whole run on the CPU at a tiny size: the window,
the traced stretch and the check. A sound run comes out correct; a run
with the timed path broken underneath comes out not correct, once for each
fault a cell can have (a step that returns its state unchanged, half of
the batch left out, an answer altered where it is produced), both from the
first tick and only after the ticks the start numbers compare (but for
half of the double's batch after the start: ``FAULTS``). Only the
look for a card is skipped: the command itself never runs on the CPU."""

import time

import pytest
import torch

import cartpole_tpu_torch.mpc.lanes as port_lanes
from conftest import TINY, tiny
from portbench import harness

FLEETS = ["single.fleet4k", "double.fleet4k", "single.grid98k"]
SEED = 2**31 + 99


def run(cell_name, trace=False, seed=SEED, dtype="float64"):
    cell = harness.load_cell(cell_name)
    return harness.run_cell(cell, seed, 0.01, trace, "cpu",
                            time.monotonic(), tiny(cell_name, dtype))


@pytest.mark.parametrize("cell", FLEETS)
def test_sound_run(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in harness.load_cell(cell).end_to_end}
    assert set(out["metrics"]) == names
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", ["single.fleet4k"])
def test_traced_run(cell):
    out = run(cell, trace=True)
    assert out["correct"], out["checks"]
    # No device on the CPU: nothing replays, the device readers find
    # nothing to read and their metrics are left out; the host-clock one
    # stays.
    assert set(out["metrics"]) == {"call_startup_s"}
    assert "busy_s" in out["device"] and "window_s" in out["device"]


def _tick_index(monkeypatch):
    """Counts the ticks of each closed-loop call of the port: ``state
    ["tick"]`` is the index, within its call, of the tick that runs."""
    state = {"tick": -1}
    make = port_lanes.tick_fn_lanes

    def counted(*args, **kwargs):
        tick = make(*args, **kwargs)
        state["tick"] = -1

        def run_tick(*a):
            state["tick"] += 1
            return tick(*a)
        return run_tick

    monkeypatch.setattr(port_lanes, "tick_fn_lanes", counted)
    return state


def _unchanged_plant(step, on):
    def broken(dp, x, *args, **kwargs):
        return x if on() else step(dp, x, *args, **kwargs)
    return broken


def _half_batch(solve, on):
    def broken(st, params, xc, spt, up, carry, n_iter):
        out, traces = solve(st, params, xc, spt, up, carry, n_iter)
        if not on():
            return out, traces
        h = carry[1].shape[-1] // 2
        xs, u = out[0].clone(), out[1].clone()
        xs[..., h:], u[..., h:] = carry[0][..., h:], carry[1][..., h:]
        return (xs, u) + tuple(out[2:]), traces
    return broken


def _altered_answer(solve, on):
    def broken(st, params, xc, spt, up, carry, n_iter):
        out, traces = solve(st, params, xc, spt, up, carry, n_iter)
        if not on():
            return out, traces
        u = out[1].clone()
        u[0] += 0.05 * (1.0 + u[0].abs())
        return (out[0], u) + tuple(out[2:]), traces
    return broken


#: Each fault from tick 0 and from the first tick after the start, in each
#: cell; but half of the double's batch left out after the start: the
#: double compares the median over every solve of its episode, and half
#: the batch is at that median's edge (PERF.md, section 7).
FAULTS = [(cell, fault, late) for late in (False, True)
          for fault in ("unchanged", "half", "altered") for cell in FLEETS
          if (cell, fault, late) != ("double.fleet4k", "half", True)]


@pytest.mark.parametrize(
    "cell, fault, late", FAULTS,
    ids=[f"{'after_start' if late else 'from_start'}-{fault}-{cell}"
         for cell, fault, late in FAULTS])
def test_fleet_fault(cell, fault, late, monkeypatch):
    state = _tick_index(monkeypatch)
    first = TINY[cell]["check"]["start_ticks"] if late else 0

    def on():
        return state["tick"] >= first

    if fault == "unchanged":
        monkeypatch.setattr(port_lanes, "simulator_step_lanes",
                            _unchanged_plant(port_lanes.simulator_step_lanes,
                                             on))
    elif fault == "half":
        monkeypatch.setattr(port_lanes, "fused_solve",
                            _half_batch(port_lanes.fused_solve, on))
    else:
        monkeypatch.setattr(port_lanes, "fused_solve",
                            _altered_answer(port_lanes.fused_solve, on))
    out = run(cell)
    assert not out["correct"], out["checks"]
    if late:
        # Only the numbers over the whole episode can see it.
        checks = out["checks"]
        for name in ("u_gap.p90", "x_gap.chain.p90"):
            assert checks[name]["value"] <= checks[name]["limit"], checks
        assert not all(c["value"] <= c["limit"] for c in checks.values())


def test_float32_program_against_the_float64_reference():
    """The configuration's own dtype on the CPU: the start's gaps are
    rounding, under their limits, and the episode's far under what a
    fault reads (1e-2 and more). A 0.2-s window: at the tiny size's 0.04 s
    the solve keeps its guess. The episode's limits are not held here:
    near upright the mean control, which scales every gap, is small, and
    this plain CPU path read 6.4e-6 where the card's runs of the cell read
    at most 2.4e-6 (``PERF.md``)."""
    cell = harness.load_cell("single.fleet4k")
    over = tiny("single.fleet4k", "float32")
    over["config"]["optimization"] = {"window_length": 20,
                                      "state_spacing": 5}
    out = harness.run_cell(cell, SEED, 0.01, False, "cpu", time.monotonic(),
                           over)
    checks = out["checks"]
    for name in ("u_gap.p90", "x_gap.chain.p90", "x_gap.p90"):
        assert 0 < checks[name]["value"] <= checks[name]["limit"], checks
    assert 0 < checks["u_gap.episode.max"]["value"] < 1e-4, checks


def test_reference_runs_in_the_program_place(monkeypatch):
    """The check judges what the window produced: the reference's tick put
    in the port's place reads no gap at all."""
    from portbench.reference.mpc import lanes as ref_lanes

    def ref_tick(mpc, dp, set_point, auto_reset=True, fused=False):
        from portbench.reference.mpc.config import OptimizationParams
        from portbench.reference.mpc.controller import MPC
        from portbench.reference.models import get_model

        rmpc = MPC(OptimizationParams(**{
            k: getattr(mpc.params, k)
            for k in mpc.params.__dataclass_fields__}),
            get_model(mpc.model.name))
        rdp = rmpc.model.params_type(**dp.as_dict())
        return ref_lanes.tick_fn_lanes(rmpc, rdp, set_point, auto_reset)

    monkeypatch.setattr(port_lanes, "tick_fn_lanes", ref_tick)
    out = run("single.fleet4k")
    assert out["correct"]
    assert all(c["value"] == 0.0 for c in out["checks"].values())


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        harness.require_chips(1)
    assert e.value.code != 0
    assert capsys.readouterr().out == ""
