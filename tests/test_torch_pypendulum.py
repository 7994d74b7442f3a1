"""The port's drop-in ``pypendulum`` shim (``cartpole_tpu_torch/pypendulum.py``)
against the JAX package's (``cartpole_tpu/pypendulum.py``).

* A one-shot solve and a 5-tick warm-start carry, through each shim's own
  stateful ``Optimization`` (``lu``, f64, window 10, spacing 2: at window 4
  the reference's lu solve accepts almost no step from these states, so
  the carry would compare cold guesses): ``u`` within 1e-8, equal
  termination codes.
* The snapshot, ``reset``, ``set_previous_solution`` and ``Simulator``
  cases of ``tests/test_pypendulum.py`` on the port's shim, on the CPU.
* The ``import pypendulum`` alias: the first shim imported keeps the name
  (``sys.modules.setdefault``), checked in a fresh interpreter, since in a
  test process the JAX package's shim may have registered it first.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

from cartpole_tpu import pypendulum as ref_pp  # noqa: E402
from cartpole_tpu_torch import pypendulum as pp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(window_length=10, state_spacing=2, max_iterations=6)
STATES = [(0.05, math.pi / 2 + 0.15 - 0.02 * t, 0.01 * t, 0.2 - 0.05 * t)
          for t in range(5)]


@pytest.fixture(autouse=True)
def on_cpu():
    before = dict(pp._config)
    pp.configure(device="cpu", dtype=torch.float64)
    yield
    pp._config.update(before)


def _carry(mod):
    """u and the termination code of each of 5 warm-started steps."""
    opt = mod.Optimization(mod.OptimizationParams(**KW))
    params = mod.SingleCartPoleParams()
    out = []
    for s in STATES:
        o = opt.step(mod.SingleCartPoleState(*s), params, 0.0)
        out.append((np.asarray(o.u),
                    int(np.asarray(o._outputs.solver.termination_state))))
    return out


@pytest.fixture(scope="module")
def reference():
    return _carry(ref_pp)


def test_warm_start_carry_matches_reference(reference):
    got = _carry(pp)
    for t, ((u, code), (u_ref, code_ref)) in enumerate(zip(got, reference)):
        np.testing.assert_allclose(u, u_ref, rtol=0, atol=1e-8,
                                   err_msg=f"tick {t}")
        assert code == code_ref, t
    # The first tick is the one-shot solve; the carry moves the solution.
    assert not np.allclose(got[0][0], got[1][0])


def test_one_shot_solve_surface():
    opt = pp.Optimization(pp.OptimizationParams(**KW))
    out = opt.step(pp.SingleCartPoleState(*STATES[0]),
                   pp.SingleCartPoleParams(), 0.0)
    assert out.solver_summary().startswith("termination = ")
    assert len(out.u) == KW["window_length"]
    assert len(out.predicted_states) == KW["window_length"]
    assert all(np.isfinite([s.b_x, s.th_1, s.b_x_dot, s.th_1_dot]).all()
               for s in out.predicted_states)
    assert out.initial_state.th_1 == STATES[0][1]
    assert out._outputs.u.device.type == "cpu"
    assert out._outputs.u.dtype == torch.float64


def test_params_snapshot_at_construction():
    params = pp.OptimizationParams()
    params.max_iterations = 4
    opt = pp.Optimization(params)
    params.max_iterations = 99
    assert opt._mpc.params.max_iterations == 4
    assert opt._mpc.params.kkt_method == "lu"
    fast = pp.Optimization(pp.OptimizationParams(), kkt_method="condensed")
    assert fast._mpc.params.kkt_method == "condensed"
    with pytest.raises(TypeError, match="unknown"):
        pp.OptimizationParams(bogus=1.0)


def test_reset_discards_warm_start():
    x0 = pp.SingleCartPoleState(*STATES[0])
    params = pp.SingleCartPoleParams()
    opt = pp.Optimization(pp.OptimizationParams(**KW))
    u_cold = opt.step(x0, params, 0.0).u
    assert not np.allclose(opt.step(x0, params, 0.0).u, u_cold)
    opt.reset()
    assert opt.step(x0, params, 0.0).u == pytest.approx(u_cold)


def test_set_previous_solution():
    x0 = pp.SingleCartPoleState(*STATES[0])
    params = pp.SingleCartPoleParams()
    a = pp.Optimization(pp.OptimizationParams(**KW))
    first = a.step(x0, params, 0.0)
    second = a.step(x0, params, 0.0)
    b = pp.Optimization(pp.OptimizationParams(**KW))
    b.set_previous_solution(first._outputs.solution.numpy())
    assert b.step(x0, params, 0.0).u == pytest.approx(second.u)
    with pytest.raises(ValueError, match="entries"):
        b.set_previous_solution([0.0, 1.0])


def test_simulator():
    sim = pp.Simulator()
    assert sim.get_state().th_1 == pytest.approx(-math.pi / 2)
    params = pp.SingleCartPoleParams()
    sim.step(params, 0.2, 0.0, f_base=pp.Vector2(5.0, 0.0))
    assert sim.get_state().b_x_dot > 0.0  # pushed to +x
    sim.set_state(pp.SingleCartPoleState(0.3, 0.1, -0.2, 0.05))
    x = sim.get_state()
    assert (x.b_x, x.th_1, x.b_x_dot, x.th_1_dot) == pytest.approx(
        (0.3, 0.1, -0.2, 0.05))
    ref = ref_pp.Simulator()
    ref.set_state(ref_pp.SingleCartPoleState(0.3, 0.1, -0.2, 0.05))
    ref.step(ref_pp.SingleCartPoleParams(), 0.05, 3.0,
             f_mass=ref_pp.Vector2(0.0, 1.0))
    sim.step(params, 0.05, 3.0, f_mass=pp.Vector2(0.0, 1.0))
    np.testing.assert_allclose(sim.get_state().to_vector(),
                               ref.get_state().to_vector(), atol=1e-12)


def test_import_alias_keeps_the_first_shim():
    code = (
        "import sys\n"
        "import cartpole_tpu_torch.pypendulum as port\n"
        "import pypendulum\n"
        "assert pypendulum is port\n"
        "import cartpole_tpu.pypendulum as ref\n"
        "assert sys.modules['pypendulum'] is port and ref is not port\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=REPO)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
