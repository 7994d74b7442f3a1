"""The port's closed loop on the double and triple cart-pole against the JAX
package's.

``cartpole_tpu_torch.run_closed_loop_lanes`` with both solve bodies
(``fused=True``: the fused iteration, whose plain version runs on CPU
tensors; ``fused=False``: the XLA-lanes body with the segment-Jacobian
kernel's plain version) is held against the jitted reference
``cartpole_tpu.mpc.lanes.run_closed_loop_lanes(..., fused=False)`` in f64 at
a tiny size: B=3, 6 ticks, window 6, spacing 2, 8 iterations, every
terminal row a soft cost (the bench regime's weights). States, controls and
terminal predictions to 1e-8, termination codes and iteration counts equal.
Each model's reference is one program, the plant disturbances ``(B, T, 2,
2)`` its argument: zeros, or (for the double) a shove at the base and the
first link mass. The two programs compile at once, in two threads (XLA
compiles outside the interpreter lock), ~1.5 min each on this CPU.
"""

import concurrent.futures

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

import jax
import jax.numpy as jnp

import cartpole_tpu as ct
from cartpole_tpu.mpc.lanes import run_closed_loop_lanes as ref_run
import cartpole_tpu_torch as pt

B, TICKS = 3, 6
KW = dict(window_length=6, state_spacing=2, max_iterations=8,
          kkt_method="condensed", th_final_cost_weight=150.0,
          th_dot_final_cost_weight=10.0, b_x_dot_final_cost_weight=10.0,
          u_guess_sinusoid_amplitude=0.0)
MODELS = ("double", "triple")
KINDS = {"double": ("zeros", "shove"), "triple": ("zeros",)}
CASES = [(m, d, f) for m in MODELS for d in KINDS[m] for f in (True, False)]
FIELDS = ("states", "controls", "terminal_predictions", "final_state")


def _x0(name, seed=0):
    """Perturbed-upright states with some link velocity."""
    sd = pt.get_model(name).state_dim
    n_q = sd // 2
    rng = np.random.RandomState(seed)
    x0 = np.zeros((B, sd))
    x0[:, 0] = rng.uniform(-0.3, 0.3, B)
    x0[:, 1:n_q] = np.pi / 2 + rng.uniform(-0.15, 0.15, (B, n_q - 1))
    x0[:, n_q + 1:] = rng.uniform(-0.5, 0.5, (B, n_q - 1))
    return x0


def _disturbances(kind):
    dist = np.zeros((B, TICKS, 2, 2))
    if kind == "shove":
        dist[:, 1:3, 1, 0] = 2.0  # horizontal, at the first link mass
        dist[:, 2, 0, 0] = -1.0  # horizontal, at the base
    return dist


def _reference_program(name):
    """The model's jitted reference closed loop, compiled, and its
    params."""
    ref_model = ct.get_model(name)
    mpc_r = ct.make_mpc(ct.OptimizationParams(**KW), ref_model)
    dp_r = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64),
                        ref_model.default_params())
    program = jax.jit(lambda x, d, dist: ref_run(mpc_r, x, d, TICKS,
                                                 disturbances=dist))
    x0 = jnp.asarray(_x0(name))
    dist = jnp.asarray(_disturbances("zeros"))
    return program.lower(x0, dp_r, dist).compile(), dp_r


@pytest.fixture(scope="module")
def runs():
    """``{(model, disturbances, fused): (port result, reference result)}``;
    one reference program per model."""
    out = {}
    with concurrent.futures.ThreadPoolExecutor(len(MODELS)) as ex:
        programs = dict(zip(MODELS, ex.map(_reference_program, MODELS)))
    for name in MODELS:
        program, dp_r = programs[name]
        model = pt.get_model(name)
        mpc = pt.make_mpc(pt.OptimizationParams(**KW), model)
        dp = model.params_type().to(torch.float64, "cpu")
        x0 = _x0(name)
        for kind in KINDS[name]:
            dist = _disturbances(kind)
            ref = program(jnp.asarray(x0), dp_r, jnp.asarray(dist))
            for fused in (True, False):
                res = pt.run_closed_loop_lanes(
                    mpc, torch.as_tensor(x0), dp, TICKS,
                    disturbances=dist, fused=fused)
                out[name, kind, fused] = (res, ref)
    return out


def _id(case):
    name, kind, fused = case
    return f"{name}-{kind}-{'fused' if fused else 'xla'}"


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_states_and_controls_match_reference(runs, case):
    res, ref = runs[case]
    for name in FIELDS:
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-8,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_codes_and_iterations_match_reference(runs, case):
    res, ref = runs[case]
    np.testing.assert_array_equal(res.termination_states.numpy(),
                                  np.asarray(ref.termination_states))
    np.testing.assert_array_equal(res.solver_iterations.numpy(),
                                  np.asarray(ref.solver_iterations))


@pytest.mark.parametrize("name", MODELS)
def test_runs_are_not_degenerate(runs, name):
    """The solver ends in more than one way, and the shove moves the
    plant."""
    res, _ = runs[name, "zeros", True]
    assert len(np.unique(res.termination_states.numpy())) > 1
    assert np.isfinite(res.states.numpy()).all()
    if name == "double":
        shoved, _ = runs[name, "shove", True]
        assert np.abs(shoved.states.numpy()
                      - res.states.numpy()).max() > 1e-3
