"""The port's web server (``cartpole_tpu_torch/web/``) against the JAX
package's, in f64 on the CPU at a small size (window 10, spacing 2, 4 GN
iterations).

* ``WebApp.snapshot()``: the same keys and values within 1e-8 as the JAX
  package's after the same ticks, pokes, slider moves, set point and
  controller toggles.
* Every request of ``tests/test_web.py`` sent to both servers, in order,
  gets the same status, and every ``/state`` body the same values within
  1e-8; except ``/optimization`` with a bool for a number field or a
  ``kkt_method`` that is not one of its names, which the JAX server takes
  (200) and the port refuses (400).
* The page: ``PAGE_HTML`` is the JAX package's with the package's name
  changed, and every path its script fetches has a route in the port's
  server (the regexes of ``tests/test_web_frontend.py``).
* Port-only: the realtime tick thread, a raising tick surfacing in
  ``/state``, the trace export, and ``WebApp()`` refusing to run without a
  card unless asked for the CPU.
"""

import inspect
import json
import math
import re
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

import jax.numpy as jnp  # noqa: E402

import cartpole_tpu as ct  # noqa: E402
from cartpole_tpu.interactive import InteractiveLoop as RefLoop  # noqa: E402
from cartpole_tpu.web import WebApp as RefApp  # noqa: E402
from cartpole_tpu.web.page import PAGE_HTML as REF_PAGE  # noqa: E402
import cartpole_tpu_torch as pt  # noqa: E402
from cartpole_tpu_torch.interactive import InteractiveLoop  # noqa: E402
from cartpole_tpu_torch.utils import tracing  # noqa: E402
from cartpole_tpu_torch.web import WebApp, server  # noqa: E402
from cartpole_tpu_torch.web.page import PAGE_HTML  # noqa: E402

KW = dict(window_length=10, state_spacing=2, max_iterations=4)
TOL = 1e-8


def _port_loop(**kw):
    return InteractiveLoop(params=pt.OptimizationParams(**KW), render=False,
                           dtype=torch.float64, device="cpu", **kw)


@pytest.fixture(scope="module")
def apps():
    """One JAX server and one port server (port 0 each), driven alike."""
    ref = RefApp(loop=RefLoop(params=ct.OptimizationParams(**KW),
                              render=False, dtype=jnp.float64),
                 realtime=False)
    port = WebApp(loop=_port_loop(), realtime=False)
    bases = []
    for app in (ref, port):
        host, p = app.start("127.0.0.1", 0)
        bases.append(f"http://{host}:{p}")
    yield ref, port, bases
    for app in (ref, port):
        app.stop()


def _same(a, b, where=""):
    """``a`` and ``b`` have the same structure and keys, equal strings,
    bools and None, and numbers within TOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (p, q) in enumerate(zip(a, b)):
            _same(p, q, f"{where}[{i}]")
    elif isinstance(a, bool) or a is None or isinstance(a, str):
        assert a == b, where
    else:
        assert b == pytest.approx(a, rel=TOL, abs=TOL), where


def test_snapshot_matches(apps):
    ref, port, _ = apps
    _same(ref.snapshot(), port.snapshot())
    steps = (
        lambda a: a.step_ticks(3),
        lambda a: (a.poke(1, 0.3), a.step_ticks(1)),
        lambda a: (a.set_dynamics(l_1=0.3, m_b=1.1), a.step_ticks(1)),
        lambda a: (a.set_control(set_point=0.1, sim_rate=0.5),
                   a.step_ticks(1)),
        lambda a: (a.set_control(enabled=False), a.step_ticks(1)),
        lambda a: (a.set_control(enabled=True), a.step_ticks(1)),
    )
    for step in steps:
        step(ref)
        step(port)
        s = port.snapshot()
        _same(ref.snapshot(), s)
    assert s["tick"] == 8 and s["predicted"] is not None
    assert np.asarray(s["predicted"]).shape == (KW["window_length"], 4)


def _request(base, path, payload):
    """GET ``path`` (payload None) or POST ``payload`` (bytes as they are,
    anything else as JSON): status and body."""
    data = None if payload is None else (
        payload if isinstance(payload, bytes)
        else json.dumps(payload).encode())
    req = urllib.request.Request(base + path, data=data,
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


#: tests/test_web.py's requests, in its order, with more /state reads
#: between them; the last is a rebuild, after which nothing ticks.
ROUTES = (
    ("/", None), ("/state", None), ("/tick", {"n": 2}), ("/state", None),
    ("/poke", {"mass_index": 0, "incident_angle": math.pi}),
    ("/state", None), ("/dynamics", {"m_1": 0.3}),
    ("/control", {"set_point": -0.2}), ("/state", None),
    ("/dynamics", {"nope": 1.0}), ("/nope", {}), ("/nope", None),
    ("/control", [1, 2, 3]), ("/poke", {"incident_angle": 0.0}),
    ("/poke", {"mass_index": "zero", "incident_angle": 0.0}),
    ("/poke", {"mass_index": 0, "incident_angle": 0.0, "massIndex": 1}),
    ("/dynamics", {"m_1": "heavy"}), ("/optimization", {"window_length": -3}),
    ("/optimization", {"bogus": 1.0}), ("/control", {"enabled": "yes"}),
    ("/control", {"sim_rat": 0.5}), ("/tick", {"n": 1.5}),
    ("/tick", {"n": 0}), ("/reset", {"hard": True}), ("/poke", b"{not json"),
    ("/tick", {"n": 1}), ("/log", None), ("/traces", None), ("/leak", None),
    ("/control", {"enabled": False}), ("/tick", {"n": 1}),
    ("/control", {"enabled": True}), ("/state", None), ("/reset", {}),
    ("/state", None), ("/optimization", {"th_final_cost_weight": 120.0}),
    ("/state", None),
)


@pytest.mark.parametrize("path,payload", ROUTES,
                         ids=[f"{i}{p}" for i, (p, _) in enumerate(ROUTES)])
def test_route_status_matches(apps, path, payload):
    _, _, (ref_base, port_base) = apps
    ref_status, ref_body = _request(ref_base, path, payload)
    status, body = _request(port_base, path, payload)
    assert status == ref_status
    if path == "/state":
        _same(json.loads(ref_body), json.loads(body))
    if path == "/log":
        assert len(json.loads(body)) == len(json.loads(ref_body))


@pytest.mark.parametrize("payload,message", [
    ({"u_cost_weight": True}, "must be a number"),
    ({"kkt_method": "qr"}, "must be one of"),
])
def test_optimization_is_typed(apps, payload, message):
    """The JAX server takes these bodies (its quirk); the port refuses
    them with a structured 400 and leaves the loop as it was."""
    ref, port, (ref_base, port_base) = apps
    before = port.loop.params
    assert _request(ref_base, "/optimization", payload)[0] == 200
    status, body = _request(port_base, "/optimization", payload)
    assert status == 400 and message in json.loads(body)["error"]
    assert port.loop.params == before
    ref.set_optimization(u_cost_weight=0.1, kkt_method="condensed")


def test_optimization_values_by_type():
    check = server._optimization_values
    assert check({"window_length": 20.0, "u_cost_weight": 1,
                  "analytic_jacobians": True, "kkt_method": "lu"}, "/o") == {
        "window_length": 20, "u_cost_weight": 1.0,
        "analytic_jacobians": True, "kkt_method": "lu"}
    for bad in ({"window_length": 20.5}, {"rebase_equalities": 1},
                {"control_dt": "0.01"}, {"kkt_method": None},
                {"max_iterations": None}):
        with pytest.raises(ValueError, match="^/o: "):
            check(bad, "/o")
    with pytest.raises(ValueError, match="unknown optimization"):
        check({"windowlength": 40}, "/o")


def test_page_is_the_jax_page():
    assert PAGE_HTML != REF_PAGE
    assert PAGE_HTML.replace("cartpole_tpu_torch", "cartpole_tpu") == REF_PAGE


def test_every_page_path_has_a_route():
    (script,) = re.findall(r"<script>(.*?)</script>", PAGE_HTML, re.DOTALL)
    routes = set(re.findall(r'path == "(/[^"]*)"', inspect.getsource(server)))
    paths = set(re.findall(r"fetch\('(/[^']*)'", script))
    paths |= set(re.findall(r"post\('(/[^']*)'", script))
    paths |= set(re.findall(r"download\('(/[^']*)'", script))
    assert {"/state", "/poke", "/dynamics", "/optimization", "/control",
            "/reset", "/log"} <= paths
    assert paths <= routes


def test_traces_export(apps):
    _, _, (_, port_base) = apps
    tracing.set_tracing_enabled(True)
    try:
        with tracing.trace_scope("web-test"):
            pass
        status, body = _request(port_base, "/traces", None)
        assert status == 200
        assert any(ev["name"] == "web-test"
                   for ev in json.loads(body)["traceEvents"])
    finally:
        tracing.set_tracing_enabled(False)


def test_realtime_thread_ticks_and_surfaces_errors():
    loop = _port_loop()
    app = WebApp(loop=loop, realtime=True)
    app.start("127.0.0.1", 0)
    try:
        deadline = time.time() + 30.0
        while loop.tick_count < 2 and time.time() < deadline:
            time.sleep(0.05)
        assert loop.tick_count >= 2
        original = loop.tick

        def failing_tick():
            raise RuntimeError("injected tick failure")

        loop.tick = failing_tick
        deadline = time.time() + 10.0
        while app.snapshot()["error"] is None and time.time() < deadline:
            time.sleep(0.05)
        assert "injected tick failure" in app.snapshot()["error"]
        loop.tick = original
        deadline = time.time() + 15.0
        while app.snapshot()["error"] is not None and time.time() < deadline:
            time.sleep(0.1)
        assert app.snapshot()["error"] is None
    finally:
        app.stop()


def test_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WebApp()
    with pytest.raises(TypeError, match="loop_kwargs"):
        WebApp(loop=_port_loop(), sim_rate=0.5)
