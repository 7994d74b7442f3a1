"""The port's per-instance MPC path against the JAX package's, in f64 at a
small size (window 10, spacing 2, 10 GN iterations).

* ``MPC.step`` for each KKT method (``lu``, ``schur``, ``condensed``), with
  segment Jacobians by AD and by the generated analytic Jacobians, on a
  batch of cold and warm starts through ``vmap`` (``torch.func.vmap`` and
  ``jax.vmap``, one jitted reference program a configuration): u and the
  solution within 1e-8 (absolute, and relative for the lu path's
  ill-conditioned KKT system), equal termination codes and iteration
  counts.
* ``run_closed_loop``, 20 ticks with a shove at the pole mass, and
  ``run_scheduled_closed_loop(layout="single")``: states and controls
  within 1e-8, equal codes and iteration counts.
* ``simulator_step``, ``Simulator`` and the poke model: 1e-12.
* Port-only: ``vmap(run_closed_loop)`` against a loop over instances; the
  per-instance condensed step against the lanes ``fused=False`` step on
  the same states (1e-9), for the single and the double pole;
  ``knockdown_report``; the warm-start state API for one instance and a
  batch.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

import jax
import jax.numpy as jnp

import cartpole_tpu as ct
from cartpole_tpu.mpc import poke as ref_poke
from cartpole_tpu.mpc.controller import MPCState as RefState
from cartpole_tpu.mpc.simulator import Simulator as RefSimulator
from cartpole_tpu.mpc.simulator import simulator_step as ref_sim
import cartpole_tpu_torch as pt
from cartpole_tpu_torch.convert import mpc_state_from_numpy, params_from_numpy
from cartpole_tpu_torch.mpc import poke

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")

KW = dict(window_length=10, state_spacing=2, max_iterations=10)
DOWN = np.array([0.0, -math.pi / 2, 0.0, 0.0])
TICKS = 20


def _params(name="single"):
    ref = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64),
                       ct.get_model(name).default_params())
    d = {k: np.asarray(v) for k, v in ref.as_dict().items()}
    return ref, params_from_numpy(d, device="cpu", model=pt.get_model(name))


def _x0s():
    """A swing-up start, a near-upright state, a moving one."""
    return np.array([[0.1, -math.pi / 2 + 0.2, 0.0, 0.0],
                     [0.2, math.pi / 2 - 0.1, 0.3, -0.2],
                     [-0.4, 0.4, 1.0, 2.0]])


def _states(dim, K):
    """Cold, cold, and a warm start whose controls are a ramp."""
    ps = np.zeros((3, dim))
    ps[2, -K:] = np.linspace(-15.0, 15.0, K)
    return ps, np.array([False, False, True])


STEP_CASES = [(kkt, aj) for kkt in ("condensed", "lu", "schur")
              for aj in (False, True)]


@pytest.fixture(scope="module")
def steps():
    ref_dp, dp = _params()
    x0s = _x0s()
    out = {}
    for kkt, aj in STEP_CASES:
        kw = dict(KW, kkt_method=kkt, analytic_jacobians=aj)
        mr = ct.make_mpc(ct.OptimizationParams(**kw))
        mp = pt.make_mpc(pt.OptimizationParams(**kw))
        ps, warm = _states(mp.spec.dim, mp.spec.window_length)
        ref, _ = jax.jit(jax.vmap(lambda s, x: mr.step(s, x, ref_dp)))(
            RefState(jnp.asarray(ps), jnp.asarray(warm)), jnp.asarray(x0s))
        got, st = torch.func.vmap(lambda s, x: mp.step(s, x, dp))(
            mpc_state_from_numpy(ps, warm, device="cpu"),
            torch.as_tensor(x0s))
        out[kkt, aj] = ref, got, st
    return out


@pytest.mark.parametrize("kkt,aj", STEP_CASES)
def test_step_matches_reference(steps, kkt, aj):
    ref, got, st = steps[kkt, aj]
    # rtol too: the lu path's KKT system (its -1e-10 constraint block)
    # amplifies f64 rounding to ~1e-9 of |u| on the warm start.
    for name in ("u", "solution", "previous_solution"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-8,
                                   rtol=1e-8)
    np.testing.assert_allclose(got.predicted_states.numpy(),
                               np.asarray(ref.predicted_states), atol=1e-8)
    for name in ("termination_state", "n_iterations"):
        np.testing.assert_array_equal(getattr(got.solver, name).numpy(),
                                      np.asarray(getattr(ref.solver, name)))
    np.testing.assert_allclose(got.solver.iter_step_size.numpy(),
                               np.asarray(ref.solver.iter_step_size))
    assert st.warm.all() and torch.equal(st.previous_solution, got.solution)


@pytest.fixture(scope="module")
def loops():
    """20 ticks with 4 N at the pole mass over ticks 5-7, and a schedule of
    a transient u-rate weight then the base weights, in both packages."""
    ref_dp, dp = _params()
    x0 = _x0s()[0]
    dist = np.zeros((TICKS, 2, 2))
    dist[5:8, 1, 0] = 4.0
    mr = ct.make_mpc(ct.OptimizationParams(**KW))
    mp = pt.make_mpc(pt.OptimizationParams(**KW))
    ref = jax.jit(lambda x, d: ct.run_closed_loop(
        mr, x, ref_dp, TICKS, disturbances=d))(jnp.asarray(x0),
                                               jnp.asarray(dist))
    got = pt.run_closed_loop(mp, torch.as_tensor(x0), dp, TICKS,
                             disturbances=dist)
    schedule = [(3, {"u_derivative_cost_weight": 0.8}), (4, None)]
    ref_s = ct.run_scheduled_closed_loop(mr, jnp.asarray(x0), ref_dp,
                                         schedule, layout="single",
                                         max_ticks_per_program=4)
    got_s = pt.run_scheduled_closed_loop(mp, torch.as_tensor(x0), dp,
                                         schedule, max_ticks_per_program=4)
    return dict(disturbed=(ref, got), scheduled=(ref_s, got_s))


@pytest.mark.parametrize("run", ["disturbed", "scheduled"])
def test_closed_loop_matches_reference(loops, run):
    ref, got = loops[run]
    for name in ("states", "controls", "final_state",
                 "terminal_predictions"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-8, rtol=0)
    np.testing.assert_allclose(got.constraint_violations.numpy(),
                               np.asarray(ref.constraint_violations),
                               atol=1e-9)
    for name in ("termination_states", "solver_iterations"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    np.testing.assert_allclose(
        got.final_mpc_state.previous_solution.numpy(),
        np.asarray(ref.final_mpc_state.previous_solution), atol=1e-8)
    assert bool(got.final_mpc_state.warm) == bool(ref.final_mpc_state.warm)


def test_disturbance_moves_the_plant(loops):
    ref, got = loops["disturbed"]
    mp = pt.make_mpc(pt.OptimizationParams(**KW))
    calm = pt.run_closed_loop(mp, torch.as_tensor(_x0s()[0]), _params()[1],
                              8)
    np.testing.assert_array_equal(got.states[:6].numpy(),
                                  calm.states[:6].numpy())
    assert (got.states[7:8] - calm.states[7:8]).abs().max() > 1e-4
    with pytest.raises(ValueError, match="num_steps, 2, 2"):
        pt.run_closed_loop(mp, torch.as_tensor(DOWN), _params()[1], 3,
                           disturbances=np.zeros((2, 2, 2)))


# ------------------------------------------------------- plant and pokes
@pytest.mark.parametrize("forces", [False, True])
@pytest.mark.parametrize("name", ["single", "double"])
def test_simulator_step_matches(name, forces):
    ref_dp, dp = _params(name)
    m, rm = pt.get_model(name), ct.get_model(name)
    rng = np.random.RandomState(5)
    x = rng.uniform(-1.0, 1.0, m.state_dim)
    f = [rng.uniform(-3, 3, 2) for _ in range(3)] if forces else [None] * 3
    kw = {} if name == "single" else {"f_mass_2": f[2]}
    for dt in (0.01, 0.0125):
        want = ref_sim(ref_dp, jnp.asarray(x), dt, 12.5, f[0], f[1],
                       model=rm, **{k: jnp.asarray(v) if v is not None
                                    else None for k, v in kw.items()})
        got = pt.simulator_step(dp, torch.as_tensor(x), dt,
                                torch.tensor(12.5, dtype=torch.float64),
                                *(None if v is None else torch.as_tensor(v)
                                  for v in f[:2]), model=m,
                                **{k: None if v is None else
                                   torch.as_tensor(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12,
                                   rtol=1e-12)


def test_simulator_class_matches():
    ref_dp, dp = _params()
    ref, sim = RefSimulator(dtype=jnp.float64), pt.Simulator(device="cpu")
    np.testing.assert_array_equal(sim.get_state().numpy(),
                                  np.asarray(ref.get_state()))
    for u in (5.0, -30.0, 0.0):
        want = ref.step(ref_dp, 0.01, u, f_mass=jnp.asarray([1.0, 0.5]))
        got = sim.step(dp, 0.01, u, f_mass=torch.tensor([1.0, 0.5],
                                                        dtype=torch.float64))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)
    sim.set_state(DOWN + 0.1)
    np.testing.assert_array_equal(sim.get_state().numpy(), DOWN + 0.1)
    with pytest.raises(ValueError, match="not finite"):
        sim.step(dp, 0.01, float("nan"))
    double = pt.Simulator(pt.DOUBLE_CARTPOLE, device="cpu")
    np.testing.assert_array_equal(double.get_state().numpy(),
                                  [0, -math.pi / 2, -math.pi / 2, 0, 0, 0])


def test_poke_matches():
    ref_dp, dp = _params()
    pokes = [(2, 1, 0.3), (6, 0, 2.0), (9, 1, -1.0)]
    want = ref_poke.make_poke_schedule(15, 0.01, pokes, ref_dp)
    got = poke.make_poke_schedule(15, 0.01, pokes, dp)
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    for m in (0, 1):
        np.testing.assert_allclose(poke.poke_force(m, 0.7, dp),
                                   ref_poke.poke_force(m, 0.7, ref_dp),
                                   atol=1e-12)
    f = np.array([[2.0, 1e-6], [-3.0, 0.5]])
    np.testing.assert_array_equal(poke.decay_external_forces(f, 0.01),
                                  ref_poke.decay_external_forces(f, 0.01))
    with pytest.raises(ValueError, match="outside"):
        poke.make_poke_schedule(5, 0.01, [(5, 0, 0.0)], dp)


# ------------------------------------------------------------ port only
def test_vmap_closed_loop_matches_a_loop():
    """``vmap(run_closed_loop)`` equals one run per instance (to the
    rounding of batched products)."""
    _, dp = _params()
    mp = pt.make_mpc(pt.OptimizationParams(window_length=6, state_spacing=2,
                                           max_iterations=6))
    x0s = torch.as_tensor(_x0s())
    res = torch.func.vmap(lambda x: pt.run_closed_loop(mp, x, dp, 4))(x0s)
    for i in range(3):
        one = pt.run_closed_loop(mp, x0s[i], dp, 4)
        for name in ("states", "controls", "terminal_predictions"):
            np.testing.assert_allclose(getattr(res, name)[i].numpy(),
                                       getattr(one, name).numpy(),
                                       atol=1e-12, rtol=1e-12)
        for name in ("termination_states", "solver_iterations"):
            assert torch.equal(getattr(res, name)[i], getattr(one, name))


@pytest.mark.parametrize("name", ["single", "double"])
def test_step_matches_the_lanes_step(name):
    """The per-instance condensed step (Cholesky and QR of the augmented
    Schur factor, AD Jacobians) against the lanes ``fused=False`` step
    (spectral solves, generated Jacobians, kernel 2's plain version) on the
    same states: the same solve to 1e-9."""
    _, dp = _params(name)
    kw = (dict(window_length=6, state_spacing=2, th_final_cost_weight=150.0,
               th_dot_final_cost_weight=10.0, b_x_dot_final_cost_weight=10.0,
               u_guess_sinusoid_amplitude=0.0) if name == "double" else KW)
    mp = pt.make_mpc(pt.OptimizationParams(**kw), pt.get_model(name))
    if name == "double":
        x0s = np.array([[0.1, math.pi / 2 + 0.1, math.pi / 2 - 0.05, 0, 0, 0],
                        [-0.2, math.pi / 2 - 0.1, math.pi / 2 + 0.1, 0.3, 0,
                         0.2]])
    else:
        x0s = _x0s()
    B = x0s.shape[0]
    st = mpc_state_from_numpy(np.zeros((B, mp.spec.dim)), np.zeros(B, bool),
                              device="cpu")
    x = torch.as_tensor(x0s)
    per, _ = torch.func.vmap(lambda s, x_: mp.step(s, x_, dp))(st, x)
    lanes, _ = pt.step_lanes(mp, st, x, dp, fused=False)
    np.testing.assert_allclose(per.u.numpy(), lanes.u.numpy(), atol=1e-9,
                               rtol=0)
    for f in ("termination_state", "n_iterations"):
        assert torch.equal(getattr(per.solver, f), getattr(lanes.solver, f))


def test_knockdown_report_matches():
    ref_dp, _ = _params("double")
    rm, m = ct.make_mpc(model=ct.get_model("double")), pt.make_mpc(
        model=pt.DOUBLE_CARTPOLE)
    rng = np.random.RandomState(3)
    states = np.full((4, 12, 6), math.pi / 2)
    states[..., 0] = rng.uniform(-1, 1, (4, 12))
    states[1, 3:, 2] += 0.8  # down from tick 3 on, never back
    states[2, 5:7, 1] -= 0.6  # down for two ticks, then recovered
    states[3, 10:, 1] += 2 * math.pi  # wrapped, still upright
    want = rm.knockdown_report(jnp.asarray(states), stuck_after=4)
    got = m.knockdown_report(torch.as_tensor(states), stuck_after=4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[1].tolist() == [-1, 3, 5, -1]
    assert got[2].tolist() == [False, True, False, False]


def test_state_api_one_instance_and_a_batch():
    mp = pt.make_mpc(pt.OptimizationParams(**KW))
    dim = mp.spec.dim
    st = mp.init_state(torch.float64, device="cpu")
    assert st.previous_solution.shape == (dim,) and not bool(st.warm)
    guess = np.arange(dim, dtype=float)
    st = mp.set_previous_solution(st, guess)
    assert bool(st.warm) and np.array_equal(st.previous_solution.numpy(),
                                            guess)
    assert torch.equal(mp.reset(st).previous_solution, torch.zeros(dim,
                       dtype=torch.float64)) and not bool(mp.reset(st).warm)
    one = mpc_state_from_numpy(guess, True, device="cpu")
    assert one.previous_solution.shape == (dim,) and one.warm.shape == ()
    # failure_mask / reset_where take one instance or a batch.
    cleared = mp.reset_where(one, torch.tensor(True))
    assert not bool(cleared.warm) and not cleared.previous_solution.any()
    kept = mp.reset_where(one, torch.tensor(False))
    assert torch.equal(kept.previous_solution, one.previous_solution)
    batch = mpc_state_from_numpy(np.ones((3, dim)), [True] * 3, device="cpu")
    out = mp.reset_where(batch, torch.tensor([False, True, False]))
    assert out.warm.tolist() == [True, False, True]
    assert out.previous_solution[1].abs().sum() == 0
    _, dp = _params()
    outputs, _ = mp.step(mp.init_state(torch.float64, "cpu"),
                         torch.as_tensor(DOWN), dp)
    assert mp.failure_mask(outputs).shape == ()
    bad = outputs._replace(solution=outputs.solution * np.nan)
    assert bool(mp.failure_mask(bad))
