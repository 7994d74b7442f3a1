"""The port's phase-scheduled closed loop (``mpc/schedule.py``), on its own
(as ``tests/test_schedule.py`` holds the JAX package's).

A schedule equals the same phases chained by hand through
``run_closed_loop_lanes``, bit for bit, with phases split into chunks; a
phase may not change the decision-vector layout or the control tick, even
where the decision vector keeps its size; ``layout="single"`` (the
per-instance loop, not ported yet) raises ``NotImplementedError``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

import cartpole_tpu_torch as pt

B = 3
KW = dict(window_length=6, state_spacing=2, max_iterations=8)
TRANSIENT = {"u_derivative_cost_weight": 0.8}
FIELDS = ("states", "controls", "terminal_predictions", "termination_states",
          "constraint_violations", "solver_iterations", "final_state")


def _setup():
    mpc = pt.make_mpc(pt.OptimizationParams(**KW))
    dp = pt.default_single_params(torch.float64, device="cpu")
    rng = np.random.RandomState(3)
    x0 = np.zeros((B, 4))
    x0[:, 0] = rng.uniform(-0.3, 0.3, B)
    x0[:, 1] = np.pi / 2 + rng.uniform(-0.5, 0.5, B)
    return mpc, dp, torch.as_tensor(x0)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "xla"])
def test_schedule_equals_hand_chained_phases(fused):
    """Phases (2 ticks with the transient weight, 3 with the base) in chunks
    of at most 2 ticks against the two phases run by hand in one call each:
    the warm start and the plant state carry across phases and chunks."""
    mpc, dp, x0 = _setup()
    res = pt.run_scheduled_closed_loop(
        mpc, x0, dp, [(2, TRANSIENT), (3, None)], layout="lanes",
        fused=fused, max_ticks_per_program=2)
    transient = pt.make_mpc(dataclasses.replace(mpc.params, **TRANSIENT),
                            mpc.model)
    r1 = pt.run_closed_loop_lanes(transient, x0, dp, 2, fused=fused)
    r2 = pt.run_closed_loop_lanes(mpc, r1.final_state, dp, 3,
                                  mpc_state=r1.final_mpc_state, fused=fused)
    assert res.states.shape == (B, 5, 4)
    for name in FIELDS:
        want = (getattr(r2, name) if name == "final_state" else
                torch.cat([getattr(r1, name), getattr(r2, name)], dim=1))
        assert torch.equal(getattr(res, name), want), name
    for a, b in zip(res.final_mpc_state, r2.final_mpc_state):
        assert torch.equal(a, b)
    # The transient weight changed the solve.
    base = pt.run_closed_loop_lanes(mpc, x0, dp, 2, fused=fused)
    assert not torch.equal(base.controls, r1.controls)


@pytest.mark.parametrize("overrides", [
    {"window_length": 8},
    {"state_spacing": 3},
    # dim 22 either way for the single model: (6/2 + 1) 4 + 6 and
    # (10/5 + 1) 4 + 10; the reference's guard lets this through.
    {"window_length": 10, "state_spacing": 5},
    {"control_dt": 0.02},
], ids=["window", "spacing", "same_dim", "control_dt"])
def test_layout_overrides_raise(overrides):
    mpc = pt.make_mpc(pt.OptimizationParams(window_length=6,
                                            state_spacing=2))
    dp = pt.default_single_params(torch.float64, device="cpu")
    x0 = torch.zeros((2, 4), dtype=torch.float64)
    if "window_length" in overrides and "state_spacing" in overrides:
        other = pt.make_mpc(dataclasses.replace(mpc.params, **overrides))
        assert other.spec.dim == mpc.spec.dim
    with pytest.raises(ValueError, match="may not change"):
        pt.run_scheduled_closed_loop(mpc, x0, dp, [(1, None), (1, overrides)],
                                     layout="lanes")


def test_single_layout_raises_not_implemented():
    mpc, dp, x0 = _setup()
    for kw in ({}, {"layout": "single"}):
        with pytest.raises(NotImplementedError, match="queue 1, item 2"):
            pt.run_scheduled_closed_loop(mpc, x0[0], dp, [(1, None)], **kw)
    with pytest.raises(ValueError, match="unknown layout"):
        pt.run_scheduled_closed_loop(mpc, x0, dp, [(1, None)], layout="rows")
    with pytest.raises(ValueError, match="at least one phase"):
        pt.run_scheduled_closed_loop(mpc, x0, dp, [], layout="lanes")
