"""Generated torch dynamics of the PyTorch port against the JAX package.

``cartpole_tpu_torch/models/_single_gen.py`` and ``csrc/single_dynamics.cuh``
are emitted from one CSE of the SymPy derivation; here the torch functions
are held against ``cartpole_tpu/models/_single_gen.py`` in f64 on random
states, to 1e-12, and the committed outputs against a fresh generation.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

import jax.numpy as jnp

from cartpole_tpu.models import _single_gen as ref_gen
from cartpole_tpu_torch.models import _single_gen as gen
from cartpole_tpu_torch.models.base import get_model
from cartpole_tpu_torch.models.params import default_single_params
from cartpole_tpu_torch.symbolic import generate

PARAMS = (1.0, 0.1, 0.25, 9.81, 0.03, 0.1, 0.13, 0.8, 100.0)


def _states(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1.0, 1.0, (4, n)) * np.array([[1.0], [4.0], [3.0], [8.0]])
    # Exercise the guarded branches: bumper contact and exact boundaries,
    # and zero pole-tip speed (the drag Piecewise and the safe sqrt).
    x[0, :4] = [0.8, -0.8, 1.2, -1.3]
    x[2:, 4] = 0.0
    u = rng.uniform(-50.0, 50.0, n)
    return x, u


def _per_instance_params(n, seed=1):
    rng = np.random.RandomState(seed)
    return tuple(v * rng.uniform(0.7, 1.3, n) for v in PARAMS)


def _to_np(v):
    return np.broadcast_to(np.asarray(v, np.float64), (64,))


@pytest.mark.parametrize("per_instance", [False, True])
def test_dynamics_core_matches_reference(per_instance):
    x, u = _states()
    p = _per_instance_params(64) if per_instance else PARAMS
    ref = ref_gen.single_dynamics_core(
        tuple(jnp.asarray(v) for v in p), jnp.asarray(x), jnp.asarray(u))
    out = gen.single_dynamics_core(
        tuple(torch.as_tensor(v, dtype=torch.float64) for v in p),
        torch.as_tensor(x), torch.as_tensor(u))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(_to_np(a), _to_np(b), rtol=1e-12,
                                   atol=1e-12)


def test_dynamics_core_with_forces():
    x, u = _states(seed=3)
    f = np.random.RandomState(4).uniform(-2.0, 2.0, (4, 64))
    ref = ref_gen.single_dynamics_core(
        tuple(jnp.asarray(v) for v in PARAMS), jnp.asarray(x),
        jnp.asarray(u), tuple(jnp.asarray(r) for r in f))
    out = gen.single_dynamics_core(
        tuple(torch.as_tensor(v, dtype=torch.float64) for v in PARAMS),
        torch.as_tensor(x), torch.as_tensor(u),
        tuple(torch.as_tensor(r) for r in f))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(_to_np(a), _to_np(b), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("per_instance", [False, True])
def test_dynamics_jac_core_matches_reference(per_instance):
    x, u = _states(seed=5)
    p = _per_instance_params(64) if per_instance else PARAMS
    xd_r, Jx_r, Ju_r = ref_gen.single_dynamics_jac_core(
        tuple(jnp.asarray(v) for v in p), jnp.asarray(x), jnp.asarray(u))
    xd, Jx, Ju = gen.single_dynamics_jac_core(
        tuple(torch.as_tensor(v, dtype=torch.float64) for v in p),
        torch.as_tensor(x), torch.as_tensor(u))
    pairs = list(zip(xd, xd_r)) + list(zip(Ju, Ju_r)) + [
        (a, b) for ra, rb in zip(Jx, Jx_r) for a, b in zip(ra, rb)]
    for a, b in pairs:
        # Structural entries stay Python literals in both packages.
        assert isinstance(a, float) == isinstance(b, float)
        np.testing.assert_allclose(_to_np(a), _to_np(b), rtol=1e-12,
                                   atol=1e-12)


def test_model_wrappers_use_field_order():
    model = get_model("single")
    x, u = _states(seed=6)
    dp = default_single_params(torch.float64, device="cpu")
    xr = tuple(torch.as_tensor(r) for r in x)
    out = model.dynamics_core(dp, xr, torch.as_tensor(u))
    ref = ref_gen.single_dynamics_core(
        tuple(jnp.asarray(v) for v in PARAMS), jnp.asarray(x), jnp.asarray(u))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(_to_np(a), _to_np(b), rtol=1e-12,
                                   atol=1e-12)
    with pytest.raises(KeyError, match="available"):
        get_model("double")


def test_generated_files_are_current():
    """The committed torch module and CUDA header are what the generator
    emits from the derivation today."""
    model = generate.load_lagrangian().derive_single_cartpole()
    with open(generate.TORCH_OUT) as f:
        assert f.read() == generate.generate_torch_module(model)
    with open(generate.CUDA_OUT) as f:
        header = f.read()
    assert header == generate.generate_cuda_header(model)
    # Precise transcendentals only: no fast-math intrinsics.
    assert "__sinf(" not in header and "__cosf(" not in header


@pytest.mark.parametrize("forces", ["none", "base", "mass", "both"])
@pytest.mark.parametrize("per_instance", [False, True])
def test_packed_dynamics_matches_reference(forces, per_instance):
    """``models/single.py::single_cartpole_dynamics`` (the hand-derived
    closed form the disturbed plant runs) against the reference's, with
    external forces at the base and at the pole mass."""
    import dataclasses

    from cartpole_tpu.models.params import (
        SingleCartPoleParams as RefSingleParams)
    from cartpole_tpu.models.single import (
        single_cartpole_dynamics as ref_dyn)
    from cartpole_tpu_torch.models.params import SingleCartPoleParams
    from cartpole_tpu_torch.models.single import single_cartpole_dynamics

    x, u = _states(seed=7)
    p = _per_instance_params(64) if per_instance else PARAMS
    names = [f.name for f in dataclasses.fields(SingleCartPoleParams)]
    dp = SingleCartPoleParams(**{
        k: torch.as_tensor(v, dtype=torch.float64) for k, v in zip(names, p)})
    dp_r = RefSingleParams(**{k: jnp.asarray(v) for k, v in zip(names, p)})
    rng = np.random.RandomState(8)
    fb = rng.uniform(-5.0, 5.0, (2, 64)) if forces in ("base", "both") \
        else None
    fm = rng.uniform(-5.0, 5.0, (2, 64)) if forces in ("mass", "both") \
        else None

    def t(a, conv):
        return None if a is None else conv(a)

    out = single_cartpole_dynamics(dp, torch.as_tensor(x), torch.as_tensor(u),
                                   t(fb, torch.as_tensor),
                                   t(fm, torch.as_tensor))
    ref = ref_dyn(dp_r, jnp.asarray(x), jnp.asarray(u), t(fb, jnp.asarray),
                  t(fm, jnp.asarray))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)
    assert get_model("single").dynamics is single_cartpole_dynamics
