"""HTTP/JSON server wrapping :class:`~cartpole_tpu_torch.interactive.InteractiveLoop`
(counterpart of ``cartpole_tpu/web/server.py``).

The original project runs the whole demo in the browser via WASM
(``viz/src/application.ts``); here the solver lives server-side on the
card, and the browser page (``page.py``) is a thin renderer + input
surface. The split preserves every behavior:

* fixed-timestep accumulator loop with the 0.2 s frame-gap watchdog
  (``application.ts:375-399``), here in the server's tick thread;
* mouse/touch pokes: nearest-mass selection + incident angle resolved by
  the client (``input.ts:44-82``), force model (10x mass, tau=0.1 s
  decay) applied by ``mpc/poke.py``;
* live dynamics sliders (inputs of the tick, no rebuild) and cost sliders /
  cost<->equality checkboxes that rebuild the optimizer
  (``application.ts:279-373``);
* controller enable toggle with warm-start reset on re-enable
  (``application.ts:209-214``);
* the 5000-entry ring-buffer solve log saved as ``log.json`` and the
  Chrome-trace export (``application.ts:344-364``, ``wasm.cc:122-138``).

Every route body is checked by type and a malformed one gets a structured
400; ``/optimization`` included, whose fields are checked against the
types of ``OptimizationParams`` (the JAX package's server passes that body
through unchecked). Every handler that reads the loop or the card holds
the app's lock, and the tick (the only place a CUDA graph is captured or
replayed) runs under it too: no other thread makes a CUDA call while a
graph is being captured.

Endpoints (all JSON unless noted):
  ``GET  /``              the HTML page
  ``GET  /state``         current plant/controller snapshot + plot rings
  ``POST /poke``          ``{"mass_index": i, "incident_angle": a}``
  ``POST /dynamics``      partial dynamics-params update (slider move)
  ``POST /optimization``  partial OptimizationParams update (rebuilds MPC)
  ``POST /control``       ``{"enabled"?, "sim_rate"?, "set_point"?}``
  ``POST /reset``         reset plant + warm start
  ``POST /tick``          ``{"n": k}`` step k ticks (headless/test mode)
  ``GET  /log``           solve log JSON array (the saveLogButton payload)
  ``GET  /traces``        Chrome trace JSON (the saveTracesButton payload)
  ``GET  /leak``          live-tensor report (the doLeakCheck analog)
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..interactive import FRAME_GAP_WATCHDOG, InteractiveLoop
from ..mpc.config import OptimizationParams
from ..ops.solver import KKT_METHODS
from ..utils import tracing

__all__ = ["WebApp", "serve"]

#: Plot history length. The reference keeps ``windowLength()`` samples per
#: plotter (``application.ts:509-526``); we keep a few windows so the strip
#: charts read as time series at browser frame rates.
PLOT_RING_WINDOWS = 8


def _json_finite(obj):
    """Map non-finite floats to ``null`` recursively. ``json.dumps``'s
    default emits bare ``NaN``/``Infinity`` tokens, which are invalid JSON
    — the browser's ``response.json()`` would throw on every poll once a
    diverged solve puts a NaN in the snapshot. (The reference's nlohmann
    serializer also dumps non-finite as ``null``.)"""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _json_finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_finite(v) for v in obj]
    return obj


def _mass_locations(x, lengths):
    """Metric positions of [base, link-1 tip, (link-2 tip)] — the pokeable
    masses (``utils.ts::massLocationsFromState`` semantics)."""
    pts = [(float(x[0]), 0.0)]
    px, py = pts[0]
    for i, l_i in enumerate(lengths):
        th = float(x[1 + i])
        px, py = px + l_i * math.cos(th), py + l_i * math.sin(th)
        pts.append((px, py))
    return pts


class WebApp:
    """Owns the interactive loop, a tick thread, and the JSON snapshot the
    page polls. All loop access is serialized by one lock: HTTP handlers
    mutate controls between ticks, never during one."""

    def __init__(
        self,
        loop: Optional[InteractiveLoop] = None,
        realtime: bool = True,
        **loop_kwargs,
    ):
        if loop is not None and loop_kwargs:
            raise TypeError(
                "loop_kwargs only apply when WebApp constructs the loop; "
                f"got an explicit loop plus {sorted(loop_kwargs)}"
            )
        self.loop = loop if loop is not None else InteractiveLoop(
            render=False, **loop_kwargs
        )
        self.loop.render = False
        self._lock = threading.RLock()
        maxlen = self.loop.params.window_length * PLOT_RING_WINDOWS
        self._plots = {
            name: collections.deque(maxlen=maxlen)
            for name in ("control", "angle", "speed")
        }
        self._predicted = None
        self._u0 = 0.0
        self._t = 0.0
        self._realtime = realtime
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._tick_error: Optional[str] = None

    # ----------------------------------------------------------------- ticks
    def tick(self) -> None:
        """One control tick + snapshot bookkeeping (updatePlots,
        ``application.ts:504-527``)."""
        with self._lock:
            lp = self.loop
            outputs = lp.tick()
            t = self._t
            self._t += lp.params.control_dt
            if outputs is not None:
                self._u0 = float(outputs.u[0])
                self._predicted = outputs.predicted_states.cpu().double() \
                    .tolist()
            else:
                self._u0 = 0.0
                self._predicted = None
            x = lp.x.cpu().double().tolist()
            self._plots["control"].append((t, self._u0))
            self._plots["angle"].append((t, math.degrees(x[1])))
            n_ang = len(lp.model.angle_indices)
            self._plots["speed"].append((t, x[1 + n_ang]))

    def step_ticks(self, n: int) -> None:
        for _ in range(int(n)):
            self.tick()

    def _run_loop(self) -> None:
        """Fixed-timestep accumulator with the frame-gap watchdog
        (``application.ts:375-399``)."""
        accum = 0.0
        last = time.perf_counter()
        while not self._stop.is_set():
            # Re-read every frame: POST /optimization can change control_dt.
            dt = self.loop.params.control_dt
            now = time.perf_counter()
            gap = now - last
            last = now
            if gap > FRAME_GAP_WATCHDOG:
                gap = 0.0  # paused/backgrounded: drop time, don't catch up
            accum += gap * self.loop.sim_rate
            while accum >= dt and not self._stop.is_set():
                try:
                    self.tick()
                except Exception as e:  # noqa: BLE001 - surface, don't die
                    # A dead tick thread looks like a silent freeze (the
                    # client keeps polling the last snapshot). Record the
                    # error for /state and back off; a transient device
                    # fault recovers, a persistent one stays visible.
                    self._tick_error = f"{type(e).__name__}: {e}"
                    accum = 0.0
                    time.sleep(1.0)
                    break
                else:
                    self._tick_error = None
                accum -= dt
            time.sleep(0.005)

    # --------------------------------------------------------------- state
    def snapshot(self) -> dict:
        with self._lock:
            lp = self.loop
            dp = {k: float(v) for k, v in lp.dp.as_dict().items()}
            lengths = [dp["l_1"]] + ([dp["l_2"]] if "l_2" in dp else [])
            x = lp.x.cpu().double().tolist()
            return {
                "model": lp.model.name,
                "tick": lp.tick_count,
                "t": self._t,
                "x": x,
                "lengths": lengths,
                "masses": _mass_locations(x, lengths),
                "enabled": lp.enabled,
                "sim_rate": lp.sim_rate,
                "set_point": lp.set_point,
                "u0": self._u0,
                "forces": lp.forces.astype(float).tolist(),
                "predicted": self._predicted if lp.enabled else None,
                "plots": {
                    k: {
                        "t": [p[0] for p in ring],
                        "y": [p[1] for p in ring],
                    }
                    for k, ring in self._plots.items()
                },
                "dynamics": dp,
                "optimization": json.loads(lp.params.to_json()),
                "tracing": tracing.is_tracing_enabled(),
                "error": self._tick_error,
            }

    # ------------------------------------------------------------- mutations
    def poke(self, mass_index: int, incident_angle: float) -> None:
        with self._lock:
            self.loop.poke(int(mass_index), float(incident_angle))

    def set_dynamics(self, **changes) -> None:
        """Unknown fields raise ``TypeError`` (``InteractiveLoop``'s)."""
        with self._lock:
            self.loop.set_dynamics(**changes)

    def set_optimization(self, **changes) -> None:
        """Rebuild with ``changes``, each checked against the type of its
        ``OptimizationParams`` field (``_optimization_values``);
        ``OptimizationParams`` itself then checks the values."""
        changes = _optimization_values(changes, "/optimization")
        with self._lock:
            self.loop.set_params(**changes)
            maxlen = self.loop.params.window_length * PLOT_RING_WINDOWS
            if self._plots["control"].maxlen != maxlen:
                self._plots = {
                    name: collections.deque(ring, maxlen=maxlen)
                    for name, ring in self._plots.items()
                }

    def set_control(self, enabled=None, sim_rate=None, set_point=None) -> None:
        with self._lock:
            lp = self.loop
            if enabled is not None and bool(enabled) != lp.enabled:
                lp.toggle_controller()
            if sim_rate is not None:
                lp.sim_rate = min(max(float(sim_rate), 0.0), 1.0)
            if set_point is not None:
                lp.set_point = float(set_point)

    def reset(self) -> None:
        with self._lock:
            self.loop.reset_plant()

    # ------------------------------------------------------------ lifecycle
    def start(self, host: str = "127.0.0.1", port: int = 8080):
        """Bind the HTTP server and (in realtime mode) start the tick
        thread. Returns the bound ``(host, port)``."""
        self._stop.clear()  # support stop()/start() cycles
        self._httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self._httpd.daemon_threads = True
        if self._realtime:
            self._thread = threading.Thread(
                target=self._run_loop, name="cartpole-web-ticks", daemon=True
            )
            self._thread.start()
        threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        ).start()
        return self._httpd.server_address

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def _reject_unknown(body: dict, allowed, path: str) -> None:
    """Schema guard for route bodies (the typed boundary the reference
    gets from embind, ``wasm.cc:30-43``): unknown keys are a structured
    400, not a silent ignore."""
    unknown = sorted(set(body) - set(allowed))
    if unknown:
        raise ValueError(
            f"{path}: unknown fields {unknown}; allowed: {sorted(allowed)}"
        )


def _field(path: str, body: dict, name: str, kind, required: bool = True,
           default=None):
    """Typed field extraction with descriptive 400 messages (a malformed
    /poke used to surface as the raw KeyError repr ``"'mass_index'"``)."""
    if name not in body or body[name] is None:
        if required:
            raise ValueError(f"{path}: missing required field {name!r}")
        return default
    v = body[name]
    if kind is bool:
        if not isinstance(v, bool):
            raise ValueError(
                f"{path}: field {name!r} must be a boolean, got "
                f"{type(v).__name__}: {v!r}"
            )
        return v
    # int / float: JSON numbers only (bool is an int subclass — exclude).
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise ValueError(
            f"{path}: field {name!r} must be a number, got "
            f"{type(v).__name__}: {v!r}"
        )
    if kind is int and int(v) != v:
        raise ValueError(
            f"{path}: field {name!r} must be an integer, got {v!r}"
        )
    return kind(v)


def _numeric_values(body: dict, path: str) -> dict:
    """A params-override body whose values must all be JSON numbers."""
    return {k: _field(path, body, k, float) for k in body}


def _optimization_values(body: dict, path: str) -> dict:
    """``body`` checked field by field against the type of the
    ``OptimizationParams`` field of that name: a float or int field takes
    a JSON number and not a bool (an int field an integral one), a bool
    field a bool, ``kkt_method`` one of ``KKT_METHODS``. Returns the
    values as the fields' types; anything else raises ``ValueError``."""
    fields = {f.name: f for f in dataclasses.fields(OptimizationParams)}
    unknown = set(body) - set(fields)
    if unknown:
        raise ValueError(f"unknown optimization fields: {sorted(unknown)}")
    out = {}
    for name in body:
        kind = type(fields[name].default)
        if kind is str:
            v = body[name]
            if v not in KKT_METHODS:
                raise ValueError(
                    f"{path}: field {name!r} must be one of "
                    f"{list(KKT_METHODS)}, got {type(v).__name__}: {v!r}")
            out[name] = v
        else:
            out[name] = _field(path, body, name, kind)
    return out


def _make_handler(app: WebApp):
    from ..utils.debug import leak_check
    from .page import PAGE_HTML

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, payload) -> None:
            self._send(
                code,
                json.dumps(_json_finite(payload)).encode(),
                "application/json; charset=utf-8",
            )

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path == "/":
                self._send(
                    200, PAGE_HTML.encode(), "text/html; charset=utf-8"
                )
            elif path == "/state":
                self._json(200, app.snapshot())
            elif path == "/log":
                with app._lock:
                    entries = json.loads(app.loop.log.to_json())
                self._json(200, entries)
            elif path == "/traces":
                with app._lock:
                    body = tracing.get_trace_json().encode()
                self._send(200, body, "application/json; charset=utf-8")
            elif path == "/leak":
                # The doLeakCheck export (wasm.cc:140-144): live tensors on
                # the loop's device instead of LSan heap objects.
                with app._lock:
                    report = leak_check(device=app.loop.device.type)
                self._json(200, report)
            else:
                self._json(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            path = self.path.split("?", 1)[0]
            n = int(self.headers.get("Content-Length") or 0)
            try:
                raw = self.rfile.read(n) or b"{}"
                try:
                    body = json.loads(raw)
                except json.JSONDecodeError as e:
                    raise ValueError(f"request body is not valid JSON: {e}")
                if not isinstance(body, dict):
                    raise ValueError("request body must be a JSON object")
                if path == "/poke":
                    _reject_unknown(
                        body, ("mass_index", "incident_angle"), path
                    )
                    app.poke(
                        _field(path, body, "mass_index", int),
                        _field(path, body, "incident_angle", float),
                    )
                elif path == "/dynamics":
                    app.set_dynamics(**_numeric_values(body, path))
                elif path == "/optimization":
                    app.set_optimization(**body)
                elif path == "/control":
                    _reject_unknown(
                        body, ("enabled", "sim_rate", "set_point"), path
                    )
                    app.set_control(
                        enabled=_field(path, body, "enabled", bool,
                                       required=False),
                        sim_rate=_field(path, body, "sim_rate", float,
                                        required=False),
                        set_point=_field(path, body, "set_point", float,
                                         required=False),
                    )
                elif path == "/reset":
                    _reject_unknown(body, (), path)
                    app.reset()
                elif path == "/tick":
                    _reject_unknown(body, ("n",), path)
                    ticks = _field(path, body, "n", int, required=False,
                                   default=1)
                    if ticks < 1:
                        raise ValueError(
                            f"{path}: field 'n' must be >= 1, got {ticks}"
                        )
                    app.step_ticks(ticks)
                else:
                    self._json(404, {"error": f"unknown path {path}"})
                    return
            except (KeyError, TypeError, ValueError) as e:
                self._json(400, {"error": str(e)})
                return
            self._json(200, {"ok": True})

    return Handler


def serve(host: str = "127.0.0.1", port: int = 8080, loop=None,
          **loop_kwargs) -> None:
    """Blocking entry point: serve until interrupted, then stop cleanly.
    Pass a prebuilt ``loop`` (the CLI does) or kwargs for a fresh
    :class:`~cartpole_tpu_torch.interactive.InteractiveLoop`."""
    app = WebApp(loop=loop, **loop_kwargs)
    bound_host, bound_port = app.start(host, port)
    print(f"cartpole_tpu_torch web demo at http://{bound_host}:{bound_port}/ "
          f"(ctrl-c to stop)")
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        app.stop()
