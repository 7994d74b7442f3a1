"""The port's copies of ``viz.py`` and ``analysis.py``: the frame-limit,
animation and strip-chart cases of ``tests/test_viz.py`` (Agg backend),
tensors as input, the CLI's ``--plot``, ``--charts`` and ``--gif``, and the
clear ``ImportError`` where matplotlib is missing."""

import math
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

from conftest import require_or_skip  # noqa: E402

from cartpole_tpu_torch import analysis, viz  # noqa: E402

DOWN = np.array([0.0, -math.pi / 2, 0.0, 0.0])
DOWN_DOUBLE = np.array([0.0, -math.pi / 2, -math.pi / 2, 0.0, 0.0, 0.0])


@pytest.fixture
def mpl():
    matplotlib = require_or_skip("matplotlib")
    matplotlib.use("Agg")
    return matplotlib


def _lowest_drawn_y(state, lengths):
    """Forward-kinematics minimum y of the drawn scene (pivot at cart top)."""
    y = 0.025 + 0.1  # _WHEEL_R + _CART_H
    lo = 0.0
    for i, length in enumerate(lengths):
        y = y + length * math.sin(state[1 + i])
        lo = min(lo, y)
    return lo


class _Result:
    def __init__(self, states, controls):
        self.states = states
        self.controls = controls


@pytest.mark.parametrize("state, lengths", [(DOWN, (0.25,)),
                                            (DOWN_DOUBLE, (0.25, 0.25))])
def test_hanging_pole_inside_frame(mpl, state, lengths):
    ax = viz.draw_frame(torch.as_tensor(state), lengths=lengths)
    lo, hi = ax.get_ylim()
    assert lo <= _lowest_drawn_y(state, lengths) - 0.02
    assert hi >= 0.125 + sum(lengths)  # the upright tip stays visible too
    ax.figure.clf()


def test_ghosts_and_force_arrow(mpl, tmp_path):
    out = tmp_path / "frame.png"
    viz.draw_frame(DOWN, predicted_states=torch.as_tensor(
        np.tile(DOWN, (40, 1))), force=50.0, save_to=str(out))
    assert out.stat().st_size > 0


def test_animation_and_strip_charts(mpl, tmp_path):
    t = np.linspace(0.0, 1.0, 6)
    states = torch.as_tensor(np.stack(
        [np.zeros_like(t), -math.pi / 2 + t * math.pi, np.zeros_like(t),
         np.zeros_like(t)], axis=1))
    res = _Result(states, torch.zeros(len(t)))
    gif, png = tmp_path / "anim.gif", tmp_path / "charts.png"
    viz.animate_closed_loop(res, stride=1, save_to=str(gif))
    viz.strip_charts(res, save_to=str(png))
    assert gif.stat().st_size > 0 and png.stat().st_size > 0


def test_analysis_plots(mpl, tmp_path):
    states = torch.as_tensor(np.tile(DOWN, (10, 1)))
    res = _Result(states, torch.linspace(-1, 1, 10))
    out = tmp_path / "loop.png"
    analysis.plot_closed_loop(res, save_to=str(out))
    assert out.stat().st_size > 0

    class _Outputs:
        predicted_states = states
        u = torch.linspace(-1, 1, 10)

    out = tmp_path / "solve.png"
    analysis.plot_solve(_Outputs(), save_to=str(out))
    assert out.stat().st_size > 0


def test_cli_plot_charts_and_gif(mpl, tmp_path, capsys):
    from cartpole_tpu_torch import cli

    log, plot = tmp_path / "log.json", tmp_path / "loop.png"
    charts, gif = tmp_path / "charts.png", tmp_path / "replay.gif"
    params = '{"window_length": 10, "state_spacing": 2, "max_iterations": 2}'
    assert cli.main(["closed-loop", "--cpu", "--params", params, "--steps",
                     "3", "--log-json", str(log), "--plot", str(plot)]) == 0
    assert cli.main(["replay", str(log), "--charts", str(charts), "--gif",
                     str(gif)]) == 0
    out = capsys.readouterr().out
    for path in (plot, charts, gif):
        assert path.stat().st_size > 0 and f"wrote {path}" in out


def test_missing_matplotlib_raises_only_when_plotting(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    res = _Result(np.tile(DOWN, (3, 1)), np.zeros(3))
    with pytest.raises(ImportError, match="needs matplotlib"):
        viz.strip_charts(res)
    with pytest.raises(ImportError, match="needs matplotlib"):
        analysis.plot_closed_loop(res, save_to="unused.png")
