"""Browser front-end for the interactive MPC loop (counterpart of
``cartpole_tpu/web``).

The original project ships its flagship demo as a WASM web app
(``viz/src/application.ts``); here the solver runs server-side on the card
and a dependency-free HTML/canvas page talks to it over a small JSON API
(``server.py``). Capability parity: mouse/touch pokes with the decaying
force model, live dynamics sliders, cost<->equality checkboxes that
rebuild the optimizer, controller toggle with warm-start reset, ghost
predictions, strip charts, and log/trace export.

Run: ``python -m cartpole_tpu_torch web [--cpu] [--port 8080]``.
"""

from .server import WebApp, serve

__all__ = ["WebApp", "serve"]
