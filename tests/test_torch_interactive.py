"""The port's interactive loop (``cartpole_tpu_torch/interactive.py``)
against the JAX package's, in f64 on the CPU at a small size (window 10,
spacing 2, 4 GN iterations).

* The same scripted keys (pokes ``b`` ``p`` ``B`` ``P``, the sliders
  ``1``-``4``, the rebuild ``t``, ``c`` off and on, ``r``; 25 ticks)
  through both loops: the plant state after every tick within 1e-8, every
  solve-log entry within 1e-8 (absolute and relative), the same
  termination states, pokes, parameters and tick counts. The two packages
  differ by ~1e-13 on the states and ~1e-10 relative on the solver's
  residual norms.
* ``render_ascii`` gives the same string.
* Port-only: with the controller off a tick solves nothing and logs
  nothing; ``set_dynamics`` writes into the loop's tensors (no rebuild)
  and refuses unknown names; ``set_params`` rebuilds and starts cold; the
  loop runs on the card by default and refuses to run without one.
"""

import io
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

import jax.numpy as jnp  # noqa: E402

import cartpole_tpu as ct  # noqa: E402
from cartpole_tpu.interactive import InteractiveLoop as RefLoop  # noqa: E402
from cartpole_tpu.interactive import render_ascii as ref_render  # noqa: E402
import cartpole_tpu_torch as pt  # noqa: E402
from cartpole_tpu_torch.interactive import (  # noqa: E402
    InteractiveLoop, render_ascii)

KW = dict(window_length=10, state_spacing=2, max_iterations=4)
#: One key (or None) per tick: pokes, the four sliders, the cost <->
#: equality rebuild, the controller off and on, the reset.
KEYS = ([None] * 3 + ["b", None, "p", "1", "2", "3", "4", None, "t", None,
                      "c", None, "c", None, None, "r", None, "B", None, "P",
                      None, None])
TICKS = len(KEYS)
ATOL = RTOL = 1e-8


def _trace(loop, to_numpy):
    """Run ``loop`` through KEYS one tick at a time; the plant state after
    every tick."""
    states = []
    for key in KEYS:
        loop.run(max_ticks=loop.tick_count + 1, realtime=False,
                 commands=[key])
        states.append(to_numpy(loop.x))
    return np.array(states)


@pytest.fixture(scope="module")
def runs():
    ref = RefLoop(params=ct.OptimizationParams(**KW), render=False,
                  dtype=jnp.float64)
    port = InteractiveLoop(params=pt.OptimizationParams(**KW), render=False,
                           dtype=torch.float64, device="cpu")
    ref_states = _trace(ref, np.asarray)
    port_states = _trace(port, lambda x: x.numpy())
    return ref, port, ref_states, port_states


def _leaves(entry, path=""):
    """A log entry's leaves as ``(path, value)`` pairs."""
    if isinstance(entry, dict):
        for k in sorted(entry):
            yield from _leaves(entry[k], f"{path}/{k}")
    elif isinstance(entry, list):
        for i, v in enumerate(entry):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, entry


def test_scripted_keys_states(runs):
    ref, port, ref_states, port_states = runs
    assert port.tick_count == ref.tick_count == TICKS
    np.testing.assert_allclose(port_states, ref_states, rtol=0, atol=ATOL)
    # the keys did what they say: a rebuild flipped the theta weight, the
    # sliders moved m_1 and l_1 and the controller ended on
    assert port.params == pt.OptimizationParams(
        **{**KW, "th_final_cost_weight": 1.0})
    assert port.enabled and ref.enabled
    for name in ("m_1", "l_1"):
        assert float(getattr(port.dp, name)) == pytest.approx(
            float(getattr(ref.dp, name)), abs=1e-15)
    np.testing.assert_allclose(port.forces, ref.forces, rtol=0, atol=1e-15)


def test_scripted_keys_log(runs):
    ref, port, _, _ = runs
    ref_log, port_log = ref.log.entries(), port.log.entries()
    # two ticks run with the controller off and log nothing
    assert len(port_log) == len(ref_log) == TICKS - 2
    for a, b in zip(ref_log, port_log):
        la, lb = list(_leaves(a)), list(_leaves(b))
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (path, va), (_, vb) in zip(la, lb):
            if isinstance(va, str) or va is None:
                assert va == vb, path
            else:
                assert vb == pytest.approx(va, rel=RTOL, abs=ATOL), path
    codes = [e["solver_outputs"]["termination_state"] for e in port_log]
    assert codes == [e["solver_outputs"]["termination_state"]
                     for e in ref_log]
    u0 = [e["u"][0] for e in port_log]
    np.testing.assert_allclose(u0, [e["u"][0] for e in ref_log], rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("x,force,enabled", [
    ((0.0, -math.pi / 2, 0.0, 0.0), None, True),
    ((0.3, math.pi / 2 + 0.2, 0.0, 0.0), 1.5, False),
    ((-1.4, 0.1, 0.0, 0.0), -2.0, True),
])
def test_render_ascii_matches(x, force, enabled):
    x = np.asarray(x)
    want = ref_render(x, ct.SingleCartPoleParams(), force=force,
                      enabled=enabled)
    assert render_ascii(x, pt.SingleCartPoleParams(), force=force,
                        enabled=enabled) == want
    dp = pt.default_single_params(torch.float64, device="cpu")
    assert render_ascii(torch.as_tensor(x), dp, force=force,
                        enabled=enabled) == want


def test_render_ascii_two_links_matches():
    x = np.array([0.1, math.pi / 2 + 0.3, math.pi / 2 - 0.4, 0, 0, 0])
    assert render_ascii(x, pt.DoubleCartPoleParams(), force=0.5) == \
        ref_render(x, ct.DoubleCartPoleParams(), force=0.5)


def _small_loop(**kw):
    kw.setdefault("params", pt.OptimizationParams(**KW))
    kw.setdefault("render", False)
    return InteractiveLoop(dtype=torch.float64, device="cpu", **kw)


def test_controller_off_ticks_the_plant_only():
    loop = _small_loop()
    loop.tick()
    loop.handle_command("c")
    x = loop.x.clone()
    assert loop.tick() is None
    assert len(loop.log) == 1
    dp = loop.dp
    want = pt.simulator_step(dp, x, 0.01, torch.zeros((), dtype=x.dtype),
                             f_base=torch.zeros(2, dtype=x.dtype),
                             f_mass=torch.zeros(2, dtype=x.dtype))
    assert torch.equal(loop.x, want)


def test_set_dynamics_writes_in_place():
    given = pt.default_single_params(torch.float64, device="cpu")
    loop = _small_loop(dynamics_params=given)
    m_1, tick = loop.dp.m_1, loop._mpc_tick
    loop.set_dynamics(m_1=0.2)
    assert loop.dp.m_1 is m_1 and float(m_1) == 0.2
    assert loop._mpc_tick is tick  # no rebuild
    assert float(given.m_1) == 0.1  # the caller's params are not touched
    with pytest.raises(TypeError, match="unknown"):
        loop.set_dynamics(m_3=1.0)


def test_set_params_rebuilds_cold():
    loop = _small_loop()
    loop.run(max_ticks=2, realtime=False)
    assert bool(loop.mpc_state.warm)
    mpc, tick = loop.mpc, loop._mpc_tick
    loop.handle_command("t")
    assert loop.mpc is not mpc and loop._mpc_tick is not tick
    assert not bool(loop.mpc_state.warm)
    assert loop.params.th_final_cost_weight == 1.0


def test_draw_and_double_model():
    buf = io.StringIO()
    loop = _small_loop(model=pt.DOUBLE_CARTPOLE, render=True, out=buf,
                       params=pt.OptimizationParams(
                           window_length=10, state_spacing=5,
                           max_iterations=2))
    assert loop.forces.shape == (3, 2) and loop.x.shape == (6,)
    loop.run(max_ticks=2, realtime=False, commands=["o", None])
    assert "ctrl=ON" in buf.getvalue()
    assert 0 < abs(loop.forces[2, 0])
    assert torch.isfinite(loop.x).all()


def test_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InteractiveLoop()
    assert InteractiveLoop.__init__.__defaults__[-1] == "cuda"
    assert InteractiveLoop.__init__.__defaults__[-3] is torch.float32
