"""Offline analysis plots — the ``model/scratch.py`` analog (counterpart of
``cartpole_tpu/analysis.py``, framework-free, copied; takes numpy arrays or
tensors on any device).

Six-panel trajectory views (angles, rates, cart position/velocity, control
and control delta — the panel layout of ``/root/reference/model/scratch.py:42-77``)
for a single solve's open-loop prediction or a full closed-loop run.
Headless-safe: uses the Agg backend when saving to a file. matplotlib is
imported only when a plot is asked for; without it that call raises
``ImportError``.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from .utils._host import host

__all__ = ["plot_solve", "plot_closed_loop"]


def _matplotlib():
    """The matplotlib module, or a clear ``ImportError`` without it."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not "
                          "installed (pip install matplotlib)") from e
    return matplotlib


def _get_axes(save_to: Optional[str]):
    matplotlib = _matplotlib()
    if save_to:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(nrows=3, ncols=2)
    fig.set_size_inches((14, 8))
    return plt, fig, axes


def _finish(plt, fig, save_to: Optional[str]):
    fig.tight_layout()
    if save_to:
        fig.savefig(save_to, dpi=120)
        plt.close(fig)
    else:
        plt.show()


def _six_panel(axes, states: np.ndarray, u: np.ndarray, dt: float):
    """states: (T, state_dim); u: (T,). Angles at indices 1..n_q-1."""
    (ax0, ax1), (ax2, ax3), (ax4, ax5) = axes
    T, sd = states.shape
    n_q = sd // 2
    t = np.arange(T) * dt

    for a in range(1, n_q):
        ax0.plot(t, states[:, a], label=f"th_{a}")
        ax1.plot(t, states[:, n_q + a], label=f"th_{a}_dot")
    ax0.axhline(np.pi / 2, color="k", ls=":", lw=0.8)
    ax0.set_ylabel("Radians")
    ax1.set_ylabel("Radians / s")
    if n_q > 2:
        ax0.legend()
        ax1.legend()

    ax2.plot(t, states[:, 0])
    ax2.set_ylabel("Meters")
    ax3.plot(t, states[:, n_q])
    ax3.set_ylabel("Meters / s")

    ax4.plot(t, u)
    ax4.set_ylabel("Newtons")
    ax5.plot(t[1:], np.diff(u))
    ax5.set_ylabel("Newtons (Delta)")

    for ax in (ax0, ax1, ax2, ax3, ax4, ax5):
        ax.set_xlabel("Time [s]")
        ax.grid()


def plot_solve(outputs: Any, control_dt: float = 0.01, save_to: Optional[str] = None):
    """Plot one solve's open-loop prediction (``MPCOutputs``)."""
    plt, fig, axes = _get_axes(save_to)
    _six_panel(
        axes,
        host(outputs.predicted_states),
        host(outputs.u),
        control_dt,
    )
    _finish(plt, fig, save_to)


def plot_closed_loop(
    result: Any, control_dt: float = 0.01, save_to: Optional[str] = None
):
    """Plot a closed-loop run (``ClosedLoopResult``)."""
    plt, fig, axes = _get_axes(save_to)
    _six_panel(
        axes, host(result.states), host(result.controls), control_dt
    )
    _finish(plt, fig, save_to)
