"""The port's fused step against the JAX package's lanes step.

``cartpole_tpu_torch.step_lanes(..., fused=True)`` runs the whole damped-GN
solve through ``ops/fused.py::fused_solve``, which on CPU tensors loops the
plain version ``fused_iteration_reference``. It is held against the jitted reference
``cartpole_tpu.mpc.lanes.step_lanes`` (the XLA lanes body, which
``tests/test_fused.py`` pins to the reference's fused body) in f64 at a tiny
size, with the tolerances of ``tests/test_fused.py:69-98``: u atol 1e-8,
solution atol 1e-7, equal termination codes and iteration counts, traces
rtol 1e-6 with the same NaN mask. Each reference program compiles once per
module.
"""

import dataclasses
import os
import subprocess
import sys

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
from cartpole_tpu.mpc.lanes import step_lanes as ref_step_lanes
import cartpole_tpu_torch as pt
from cartpole_tpu_torch.convert import mpc_state_from_numpy, params_from_numpy
from cartpole_tpu_torch.mpc.lanes import _init_carry, _prepare
from cartpole_tpu_torch.ops import fused

B = 4
KW = dict(window_length=10, state_spacing=2, max_iterations=8,
          kkt_method="condensed")
TRACES = ("iter_cost", "iter_violation", "iter_lambda", "iter_step_size",
          "iter_first_order")


def x0_batch(seed=0):
    """One instance hanging, three near upright: a mix of iteration counts
    and termination codes at this window."""
    rng = np.random.RandomState(seed)
    x0 = np.tile([0.0, np.pi / 2, 0.0, 0.0], (B, 1))
    x0[:, 0] += rng.uniform(-0.5, 0.5, B)
    x0[:, 1] += rng.uniform(-0.3, 0.3, B)
    x0[0] = [0.1, -np.pi / 2 + 0.2, 0.0, 0.0]
    return x0


def _np_params(dp):
    return {k: np.asarray(v) for k, v in dp.as_dict().items()}


def _port_step(kw, dp_np, state_np, x0):
    mpc = pt.make_mpc(pt.OptimizationParams(**kw))
    out, _ = pt.step_lanes(
        mpc, mpc_state_from_numpy(*state_np, device="cpu"),
        torch.as_tensor(np.array(x0)), params_from_numpy(dp_np, device="cpu"),
        0.0, fused=True)
    return out


def _ref_params(per_instance):
    """Dynamics params with per-instance ``(B,)`` mass and length: a (mass,
    length) grid, or the defaults repeated."""
    dp = ref_default_params(jnp.float64)
    if per_instance:
        grid = np.stack(np.meshgrid([0.08, 0.12], [0.2, 0.3]),
                        -1).reshape(B, 2)
    else:
        grid = np.tile([float(dp.m_1), float(dp.l_1)], (B, 1))
    return dataclasses.replace(dp, m_1=jnp.asarray(grid[:, 0]),
                               l_1=jnp.asarray(grid[:, 1]))


@pytest.fixture(scope="module")
def cases():
    """Reference and port outputs for each case, computed once. One
    reference program serves every case: u_limit 40, which binds in the line
    search, and the params an argument with per-instance leaves."""
    out = {}
    sp = jnp.zeros((B,))
    kw40 = dict(KW, u_limit=40.0)
    mpc_r = ref_make_mpc(RefParams(**kw40))
    step = jax.jit(lambda s, x, d: ref_step_lanes(mpc_r, s, x, d, sp))
    st0 = RefState(previous_solution=jnp.zeros((B, mpc_r.spec.dim)),
                   warm=jnp.zeros((B,), bool))
    zeros = (np.zeros((B, mpc_r.spec.dim)), np.zeros(B, bool))

    # A cold tick, then a warm one.
    dp = _ref_params(False)
    x0 = x0_batch(1)
    ref1, st1 = step(st0, jnp.asarray(x0), dp)
    x1 = np.asarray(ref1.predicted_states[:, 0, :])
    ref2, _ = step(st1, jnp.asarray(x1), dp)
    out["cold_ulimit40"] = (ref1, _port_step(kw40, _np_params(dp), zeros, x0))
    warm = (np.asarray(st1.previous_solution), np.asarray(st1.warm))
    out["warm_ulimit40"] = (ref2, _port_step(kw40, _np_params(dp), warm, x1))

    # Per-instance (mass, length) grid.
    dp = _ref_params(True)
    x0 = x0_batch(7)
    ref, _ = step(st0, jnp.asarray(x0), dp)
    out["per_instance_params"] = (
        ref, _port_step(kw40, _np_params(dp), zeros, x0))
    return out


CASES = ("cold_ulimit40", "warm_ulimit40", "per_instance_params")


@pytest.mark.parametrize("case", CASES)
def test_controls_and_solution(cases, case):
    ref, out = cases[case]
    np.testing.assert_allclose(out.u.numpy(), np.asarray(ref.u), atol=1e-8)
    np.testing.assert_allclose(out.solution.numpy(), np.asarray(ref.solution),
                               atol=1e-7)
    np.testing.assert_allclose(out.previous_solution.numpy(),
                               np.asarray(ref.previous_solution), atol=1e-12)


@pytest.mark.parametrize("case", CASES)
def test_termination_and_iterations(cases, case):
    ref, out = cases[case]
    np.testing.assert_array_equal(out.solver.termination_state.numpy(),
                                  np.asarray(ref.solver.termination_state))
    np.testing.assert_array_equal(out.solver.n_iterations.numpy(),
                                  np.asarray(ref.solver.n_iterations))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", TRACES)
def test_iteration_traces(cases, case, name):
    ref, out = cases[case]
    a = getattr(out.solver, name).numpy()
    b = np.asarray(getattr(ref.solver, name))
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    m = ~np.isnan(a)
    np.testing.assert_allclose(a[m], b[m], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("case", CASES)
def test_final_diagnostics_and_prediction(cases, case):
    ref, out = cases[case]
    s, r = out.solver, ref.solver
    np.testing.assert_allclose(s.first_order_norm.numpy(),
                               np.asarray(r.first_order_norm),
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(s.cost.numpy(), np.asarray(r.cost),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(s.constraint_violation.numpy(),
                               np.asarray(r.constraint_violation),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(s.lambda_final.numpy(),
                               np.asarray(r.lambda_final), rtol=1e-12)
    np.testing.assert_allclose(out.predicted_states.numpy(),
                               np.asarray(ref.predicted_states), atol=1e-7)


def test_cases_cover_several_outcomes(cases):
    """The inputs are not degenerate: codes and iteration counts vary and
    the u limit binds."""
    codes = np.concatenate([np.asarray(cases[c][0].solver.termination_state)
                            for c in CASES])
    iters = np.concatenate([np.asarray(cases[c][0].solver.n_iterations)
                            for c in CASES])
    assert len(set(codes.tolist())) >= 2 and len(set(iters.tolist())) >= 3
    assert np.isclose(np.abs(np.asarray(cases["cold_ulimit40"][0].u)).max(),
                      40.0)


def test_port_never_imports_jax():
    code = ("import sys, cartpole_tpu_torch, cartpole_tpu_torch.ops.fused, "
            "cartpole_tpu_torch.ops._build, cartpole_tpu_torch.convert, "
            "cartpole_tpu_torch.ops.pallas_kernels, "
            "cartpole_tpu_torch.ops.lanes, cartpole_tpu_torch.mpc.lanes, "
            "cartpole_tpu_torch.models.single, "
            "cartpole_tpu_torch.tools.sweep_fused_layout; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.split('.')[0] == 'cartpole_tpu' "
            "for m in sys.modules), 'cartpole_tpu imported'")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def _small_problem():
    mpc = pt.make_mpc(pt.OptimizationParams(**KW))
    dp = pt.default_single_params(torch.float64, device="cpu")
    st = pt.MPCState(torch.zeros((B, mpc.spec.dim), dtype=torch.float64),
                     torch.zeros((B,), dtype=torch.bool))
    problem, Z0 = _prepare(mpc, st, torch.as_tensor(x0_batch()), dp)
    args = (problem.statics.fused, dp, problem.x_current, problem.set_point,
            problem.u_prev)
    return mpc, args, _init_carry(Z0, mpc.nls_config)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors fused_solve loops fused_iteration_reference and never
    counts a kernel launch."""
    mpc, args, carry = _small_problem()
    before = fused.fused_solve.launches
    c, tr = fused.fused_solve(*args, carry, 3)
    assert fused.fused_solve.launches == before
    c_ref = carry
    for _ in range(3):
        c_ref = fused.fused_iteration_reference(*args, *c_ref)[:8]
    for a, b in zip(c, c_ref):
        assert torch.equal(a, b)
    assert all(t.shape == (3, B) for t in tr)


def test_kernel_guards_raise():
    """The CUDA path raises on f64 and on sizes beyond the kernel's maxima;
    it has no fallback to the plain version."""
    mpc, args, carry = _small_problem()
    with pytest.raises(TypeError, match="f32-only"):
        fused._launch_cuda(*args, carry, 8)
    big = pt.make_mpc(pt.OptimizationParams(window_length=80,
                                            state_spacing=5))
    st = pt.MPCState(torch.zeros((B, big.spec.dim)),
                     torch.zeros((B,), dtype=torch.bool))
    problem, _ = _prepare(big, st, torch.zeros((B, 4)),
                          pt.default_single_params(device="cpu"))
    with pytest.raises(ValueError, match="limits"):
        fused.check_sizes(problem.statics.fused)


def test_fused_raises_where_the_reference_raises():
    """``fused=True`` with ``rebase_equalities=True`` and hard terminal
    equalities raises the reference's ``ValueError`` (mpc/lanes.py:702-708)
    instead of solving without the re-basing; so do dynamics params that
    are neither 0-d nor ``(B,)``."""
    from cartpole_tpu.mpc.lanes import step_lanes as ref_step

    x0 = torch.as_tensor(x0_batch())
    kw = dict(KW, rebase_equalities=True)
    mpc = pt.make_mpc(pt.OptimizationParams(**kw))
    st = pt.MPCState(torch.zeros((B, mpc.spec.dim), dtype=torch.float64),
                     torch.zeros((B,), dtype=torch.bool))
    dp = pt.default_single_params(torch.float64, device="cpu")
    with pytest.raises(ValueError) as port_err:
        pt.step_lanes(mpc, st, x0, dp, fused=True)
    mpc_r = ref_make_mpc(RefParams(**kw))
    st_r = RefState(previous_solution=jnp.zeros((B, mpc_r.spec.dim)),
                    warm=jnp.zeros((B,), bool))
    with pytest.raises(ValueError) as ref_err:
        ref_step(mpc_r, st_r, jnp.asarray(x0.numpy()),
                 ref_default_params(jnp.float64), fused=True)
    assert str(port_err.value) == str(ref_err.value)
    bad = dataclasses.replace(dp, m_1=torch.full((1,), 0.1,
                                                 dtype=torch.float64))
    mpc = pt.make_mpc(pt.OptimizationParams(**KW))
    with pytest.raises(ValueError, match="not covered by the fused kernel"):
        pt.step_lanes(mpc, st, x0, bad, fused=True)


@pytest.mark.parametrize("alpha", [0.5, "per_instance"])
def test_lanes_problem_evaluate_and_retract(alpha):
    """``_LanesProblem.evaluate`` and ``retract`` against the reference's on
    a random iterate: residual and constraint rows in the same order,
    and the same wrap and clamps."""
    from cartpole_tpu.mpc.lanes import _LanesProblem as RefProblem
    from cartpole_tpu.mpc.lanes import _Z as RefZ
    from cartpole_tpu_torch.mpc.lanes import _Z, _LanesProblem, _lanes_statics

    mpc = pt.make_mpc(pt.OptimizationParams(**KW))
    mpc_r = ref_make_mpc(RefParams(**KW))
    rng = np.random.RandomState(9)
    N, K = mpc.spec.num_states, mpc.spec.window_length
    xs = rng.uniform(-4.0, 4.0, (4, N, B))
    u = rng.uniform(-400.0, 400.0, (K, B))
    dxs = rng.uniform(-4.0, 4.0, (4, N, B))
    du = rng.uniform(-50.0, 50.0, (K, B))
    xc = rng.uniform(-1.0, 1.0, (4, B))
    spt, up = rng.uniform(-0.5, 0.5, B), rng.uniform(-5.0, 5.0, B)
    a = 0.5 if alpha == 0.5 else rng.uniform(0.0, 1.0, B)
    t = torch.as_tensor
    prob = _LanesProblem(mpc.spec, t(xc), t(spt), t(up),
                         pt.default_single_params(torch.float64, "cpu"),
                         _lanes_statics(mpc, torch.float64, t(xc).device))
    ref = RefProblem(mpc_r.spec, jnp.asarray(xc), jnp.asarray(spt),
                     jnp.asarray(up), ref_default_params(jnp.float64))
    r, c = prob.evaluate(_Z(t(xs), t(u)))
    r_ref, c_ref = ref.evaluate(RefZ(jnp.asarray(xs), jnp.asarray(u)))
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-12,
                               atol=1e-12)
    Z = prob.retract(_Z(t(xs), t(u)), _Z(t(dxs), t(du)), t(a))
    Z_ref = ref.retract(RefZ(jnp.asarray(xs), jnp.asarray(u)),
                        RefZ(jnp.asarray(dxs), jnp.asarray(du)),
                        jnp.asarray(a))
    np.testing.assert_allclose(Z.xs.numpy(), np.asarray(Z_ref.xs), atol=1e-13)
    np.testing.assert_allclose(Z.u.numpy(), np.asarray(Z_ref.u), atol=1e-13)
