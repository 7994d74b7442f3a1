"""The port's non-fused lanes solve and disturbed plant against the JAX
package's.

``cartpole_tpu_torch.step_lanes(..., fused=False)`` runs the reference's
XLA-lanes body: per iteration ``_LanesProblem.condensed_step`` (its
linearization through ``ops/pallas_kernels.segment_jac_batch_last``, which
takes its plain version on CPU tensors) and one folded evaluation of all
line-search trials. In f64 at a tiny size (window 10, spacing 2, 8
iterations, B=4) it is held against the jitted reference
``cartpole_tpu.mpc.lanes.step_lanes(..., fused=False)`` with the tolerances
of ``tests/test_lanes.py:62-112``: u and solution atol 1e-9, identical
termination codes and iteration counts. ``condensed_step`` is held to 1e-9
on random iterates, the 10-tick closed loop with and without plant
disturbances to 1e-8 in the states (``tests/test_lanes.py:272-308``), the
packed disturbed plant step to 1e-12, and the port's two solve bodies
against each other with the tolerances of ``tests/test_fused.py:69-98``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

import jax
import jax.numpy as jnp

from cartpole_tpu import OptimizationParams as RefParams
from cartpole_tpu import default_single_params as ref_default_params
from cartpole_tpu import make_mpc as ref_make_mpc
from cartpole_tpu.mpc.controller import MPCState as RefState
from cartpole_tpu.mpc.lanes import _LanesProblem as RefProblem
from cartpole_tpu.mpc.lanes import _Z as RefZ
from cartpole_tpu.mpc.lanes import run_closed_loop_lanes as ref_run
from cartpole_tpu.mpc.lanes import simulator_step_lanes as ref_sim
from cartpole_tpu.mpc.lanes import step_lanes as ref_step_lanes
import cartpole_tpu_torch as pt
from cartpole_tpu_torch.convert import mpc_state_from_numpy, params_from_numpy
from cartpole_tpu_torch.mpc import lanes

B, TICKS = 4, 10
KW = dict(window_length=10, state_spacing=2, max_iterations=8,
          kkt_method="condensed")
TRACES = ("iter_cost", "iter_violation", "iter_lambda", "iter_step_size",
          "iter_first_order")


def x0_batch(seed=0):
    """One instance hanging, three near upright."""
    rng = np.random.RandomState(seed)
    x0 = np.tile([0.0, np.pi / 2, 0.0, 0.0], (B, 1))
    x0[:, 0] += rng.uniform(-0.5, 0.5, B)
    x0[:, 1] += rng.uniform(-0.3, 0.3, B)
    x0[0] = [0.1, -np.pi / 2 + 0.2, 0.0, 0.0]
    return x0


def _np_params(dp):
    return {k: np.asarray(v) for k, v in dp.as_dict().items()}


def _ref_params(per_instance, uniform=False):
    """The default params; with ``per_instance`` a (mass, length) grid as
    ``(B,)`` leaves, with ``uniform`` the defaults as such leaves."""
    dp = ref_default_params(jnp.float64)
    if not (per_instance or uniform):
        return dp
    if per_instance:
        grid = np.stack(np.meshgrid([0.08, 0.12], [0.2, 0.3]),
                        -1).reshape(B, 2)
    else:
        grid = np.tile([float(dp.m_1), float(dp.l_1)], (B, 1))
    return dataclasses.replace(dp, m_1=jnp.asarray(grid[:, 0]),
                               l_1=jnp.asarray(grid[:, 1]))


def _port_step(kw, dp_np, state_np, x0, fused=False):
    mpc = pt.make_mpc(pt.OptimizationParams(**kw))
    out, _ = pt.step_lanes(
        mpc, mpc_state_from_numpy(*state_np, device="cpu"),
        torch.as_tensor(np.array(x0)), params_from_numpy(dp_np, device="cpu"),
        0.0, fused=fused)
    return out


@pytest.fixture(scope="module")
def steps():
    """Reference and port ``fused=False`` outputs of each step case; one
    reference program per configuration, the params its argument (the
    u_limit-40 program serves the per-instance case too)."""
    out = {}
    sp = jnp.zeros((B,))
    programs = {}

    def run(name, kw, dp, x0, warm_name=None):
        key = tuple(sorted(kw.items()))
        if key not in programs:
            mpc_r = ref_make_mpc(RefParams(**kw))
            programs[key] = (mpc_r, jax.jit(
                lambda s, x, d: ref_step_lanes(mpc_r, s, x, d, sp)))
        mpc_r, step = programs[key]
        st = RefState(previous_solution=jnp.zeros((B, mpc_r.spec.dim)),
                      warm=jnp.zeros((B,), bool))
        for case in (name, warm_name):
            if case is None:
                break
            ref, st2 = step(st, jnp.asarray(x0), dp)
            state_np = (np.asarray(st.previous_solution), np.asarray(st.warm))
            out[case] = (ref, _port_step(kw, _np_params(dp), state_np, x0))
            st, x0 = st2, np.asarray(ref.predicted_states[:, 0, :])

    # u_limit 40 binds in the line search: a cold tick, then a warm one.
    kw40 = dict(KW, u_limit=40.0)
    run("cold_ulimit40", kw40, _ref_params(False, uniform=True), x0_batch(1),
        "warm_ulimit40")
    run("per_instance_params", kw40, _ref_params(True), x0_batch(2))
    run("rebase_equalities", dict(KW, rebase_equalities=True),
        _ref_params(False), x0_batch(3))
    return out


STEP_CASES = ("cold_ulimit40", "warm_ulimit40", "per_instance_params",
              "rebase_equalities")


@pytest.mark.parametrize("case", STEP_CASES)
def test_step_controls_and_solution(steps, case):
    ref, out = steps[case]
    np.testing.assert_allclose(out.u.numpy(), np.asarray(ref.u), atol=1e-9)
    np.testing.assert_allclose(out.solution.numpy(), np.asarray(ref.solution),
                               atol=1e-9)
    np.testing.assert_allclose(out.previous_solution.numpy(),
                               np.asarray(ref.previous_solution), atol=1e-12)
    np.testing.assert_allclose(out.predicted_states.numpy(),
                               np.asarray(ref.predicted_states), atol=1e-9)


@pytest.mark.parametrize("case", STEP_CASES)
def test_step_termination_and_iterations(steps, case):
    ref, out = steps[case]
    np.testing.assert_array_equal(out.solver.termination_state.numpy(),
                                  np.asarray(ref.solver.termination_state))
    np.testing.assert_array_equal(out.solver.n_iterations.numpy(),
                                  np.asarray(ref.solver.n_iterations))
    np.testing.assert_allclose(out.solver.first_order_norm.numpy(),
                               np.asarray(ref.solver.first_order_norm),
                               rtol=1e-6, atol=1e-12)
    for name in TRACES:
        a = getattr(out.solver, name).numpy()
        b = np.asarray(getattr(ref.solver, name))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        m = ~np.isnan(a)
        np.testing.assert_allclose(a[m], b[m], rtol=1e-6, atol=1e-9)


def test_step_cases_are_not_degenerate(steps):
    codes = np.concatenate([np.asarray(steps[c][0].solver.termination_state)
                            for c in STEP_CASES])
    iters = np.concatenate([np.asarray(steps[c][0].solver.n_iterations)
                            for c in STEP_CASES])
    assert len(set(codes.tolist())) >= 2 and len(set(iters.tolist())) >= 3
    assert np.isclose(np.abs(np.asarray(steps["cold_ulimit40"][0].u)).max(),
                      40.0)


@pytest.mark.parametrize("case", ["default", "per_instance_params",
                                  "rebase_equalities"])
def test_condensed_step_matches_reference(case):
    """``condensed_step`` on a random iterate: the step, the multiplier
    bound, the first-order diagnostic, ``(J^T r) . dz``, the QP flag and the
    residual and constraint rows."""
    kw = dict(KW, rebase_equalities=case == "rebase_equalities")
    mpc = pt.make_mpc(pt.OptimizationParams(**kw))
    mpc_r = ref_make_mpc(RefParams(**kw))
    rng = np.random.RandomState(11)
    N, K = mpc.spec.num_states, mpc.spec.window_length
    xs = rng.uniform(-1.0, 1.0, (4, N, B)) * np.array([1.0, 3.0, 2.0, 5.0])[
        :, None, None]
    u = rng.uniform(-30.0, 30.0, (K, B))
    xc = xs[:, 0, :] + rng.uniform(-0.1, 0.1, (4, B))
    spt, up = rng.uniform(-0.5, 0.5, B), rng.uniform(-5.0, 5.0, B)
    lam = rng.uniform(1e-3, 1.0, B)
    dp_r = _ref_params(case == "per_instance_params")
    dp = params_from_numpy(_np_params(dp_r), device="cpu")
    t = torch.as_tensor
    prob = lanes._LanesProblem(
        mpc.spec, t(xc), t(spt), t(up), dp,
        lanes._lanes_statics(mpc, torch.float64, torch.device("cpu")))
    ref = RefProblem(mpc_r.spec, jnp.asarray(xc), jnp.asarray(spt),
                     jnp.asarray(up), dp_r)
    got = prob.condensed_step(lanes._Z(t(xs), t(u)), t(lam))
    want = ref.condensed_step(RefZ(jnp.asarray(xs), jnp.asarray(u)),
                              jnp.asarray(lam))
    (dZ, *rest), (dZ_r, *rest_r) = got, want
    pairs = [("dxs", dZ.xs, dZ_r.xs), ("du", dZ.u, dZ_r.u)] + list(zip(
        ("nu_inf", "first_order", "jr_dz", "ok", "r", "c"), rest, rest_r))
    for name, a, b in pairs:
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9, err_msg=name)
    assert bool(np.all(got[4].numpy()))


def _disturbances():
    dist = np.zeros((B, TICKS, 2, 2))
    dist[:, 3:6, 1, 0] = 30.0  # x-force at the pole mass
    dist[:, 4, 0, 1] = -5.0  # y-force at the base
    return dist


@pytest.fixture(scope="module")
def loops():
    """The port's loop without and with disturbances against one reference
    program, the disturbances its argument: zero forces for the port's
    undisturbed loop."""
    x0 = x0_batch(5)
    mpc_r = ref_make_mpc(RefParams(**KW))
    dp = ref_default_params(jnp.float64)
    run = jax.jit(lambda x, d: ref_run(mpc_r, x, dp, TICKS, disturbances=d))
    mpc = pt.make_mpc(pt.OptimizationParams(**KW))
    dp_t = params_from_numpy(_np_params(dp), device="cpu")
    out = {}
    for name, dist in (("plain", None), ("disturbed", _disturbances())):
        ref = run(jnp.asarray(x0), jnp.asarray(
            np.zeros((B, TICKS, 2, 2)) if dist is None else dist))
        out[name] = (ref, pt.run_closed_loop_lanes(
            mpc, torch.as_tensor(x0), dp_t, TICKS, disturbances=dist))
    return out


@pytest.mark.parametrize("case", ["plain", "disturbed"])
def test_closed_loop_matches_reference(loops, case):
    ref, out = loops[case]
    for name, atol in (("states", 1e-8), ("controls", 1e-8),
                       ("final_state", 1e-8)):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=atol,
                                   err_msg=name)
    for name in ("termination_states", "solver_iterations"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)))


def test_disturbance_alters_the_trajectory(loops):
    a = loops["plain"][1].states.numpy()
    b = loops["disturbed"][1].states.numpy()
    assert np.abs(a - b).max() > 1e-3


@pytest.mark.parametrize("forces", ["per_instance", "shared"])
def test_disturbed_plant_step_matches_reference(forces):
    rng = np.random.RandomState(6)
    x = rng.uniform(-1.0, 1.0, (4, 6)) * np.array([[0.5], [3.0], [2.0], [5.0]])
    u = rng.uniform(-40.0, 40.0, 6)
    shape = (2, 6) if forces == "per_instance" else (2,)
    fb, fm = rng.uniform(-20.0, 20.0, shape), rng.uniform(-20.0, 20.0, shape)
    dp = ref_default_params(jnp.float64)
    for dt in (0.01, 0.0125):
        ref = ref_sim(dp, jnp.asarray(x), dt, jnp.asarray(u), jnp.asarray(fb),
                      jnp.asarray(fm))
        out = pt.simulator_step_lanes(
            pt.default_single_params(torch.float64, device="cpu"),
            torch.as_tensor(x), dt, torch.as_tensor(u), torch.as_tensor(fb),
            torch.as_tensor(fm))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                                   atol=1e-12)


def test_port_bodies_agree(steps):
    """Port ``fused=False`` against port ``fused=True`` on the same problem
    (the counterpart of ``tests/test_fused.py:101-117``)."""
    x0 = x0_batch(1)
    zeros = (np.zeros((B, pt.make_mpc(pt.OptimizationParams(**KW)).spec.dim)),
             np.zeros(B, bool))
    dp_np = _np_params(ref_default_params(jnp.float64))
    a = _port_step(KW, dp_np, zeros, x0, fused=False)
    b = _port_step(KW, dp_np, zeros, x0, fused=True)
    np.testing.assert_allclose(a.u.numpy(), b.u.numpy(), atol=1e-8)
    np.testing.assert_allclose(a.solution.numpy(), b.solution.numpy(),
                               atol=1e-7)
    for name in ("termination_state", "n_iterations"):
        np.testing.assert_array_equal(getattr(a.solver, name).numpy(),
                                      getattr(b.solver, name).numpy())
    for name in TRACES:
        x, y = getattr(a.solver, name).numpy(), getattr(b.solver, name).numpy()
        np.testing.assert_array_equal(np.isnan(x), np.isnan(y))
        m = ~np.isnan(x)
        np.testing.assert_allclose(x[m], y[m], rtol=1e-6, atol=1e-9)


def _matmul_precision():
    mm = torch.backends.cuda.matmul
    if hasattr(mm, "fp32_precision"):
        return mm.fp32_precision
    return torch.get_float32_matmul_precision()


def test_solve_keeps_full_f32_matmul_precision(monkeypatch):
    """Under ``torch.set_float32_matmul_precision("high")`` the solve still
    runs its matmuls in full f32 (the u of an f32 step equals the u under
    the default) and the caller's setting comes back afterwards."""
    mpc = pt.make_mpc(pt.OptimizationParams(**KW))
    dp = pt.default_single_params(torch.float32, device="cpu")
    x0 = torch.as_tensor(x0_batch(1), dtype=torch.float32)
    st = pt.MPCState(torch.zeros((B, mpc.spec.dim)),
                     torch.zeros((B,), dtype=torch.bool))
    seen = []
    step = lanes._LanesProblem.condensed_step

    def spy(self, Z, lam):
        seen.append(_matmul_precision())
        return step(self, Z, lam)

    monkeypatch.setattr(lanes._LanesProblem, "condensed_step", spy)
    before = _matmul_precision()
    u_default = pt.step_lanes(mpc, st, x0, dp)[0].u
    torch.set_float32_matmul_precision("high")
    try:
        high = _matmul_precision()
        u_high = pt.step_lanes(mpc, st, x0, dp)[0].u
        after = _matmul_precision()
    finally:
        torch.set_float32_matmul_precision("highest")
    assert high != before and after == high
    assert torch.equal(u_high, u_default)
    assert seen and set(seen) == {"ieee" if hasattr(
        torch.backends.cuda.matmul, "fp32_precision") else "highest"}
