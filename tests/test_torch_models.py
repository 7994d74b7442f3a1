"""The double and triple cart-pole models of the PyTorch port against the JAX
package.

In f64 on random states, to 1e-12: the generated rows cores and Jacobian
cores (``cartpole_tpu_torch/models/_{double,triple}_gen.py`` against
``cartpole_tpu/models/_{double,triple}_gen.py``), the packed dynamics with
every combination of external forces (the double's hand-derived adjugate
form and the triple's generated core), and the energy of all three models.
Also the registry, the parameter defaults and ``params_from_numpy`` round
trips, and that the import scan of ``tests/test_torch_dynamics.py`` reaches
the new files.
"""

import dataclasses
import itertools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

import jax.numpy as jnp

import cartpole_tpu as ct
from cartpole_tpu.models import _double_gen as ref_double_gen
from cartpole_tpu.models import _triple_gen as ref_triple_gen
import cartpole_tpu_torch as pt
from cartpole_tpu_torch.convert import params_from_numpy
from cartpole_tpu_torch.models import _double_gen, _triple_gen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 64
GEN = {"double": (_double_gen, ref_double_gen),
       "triple": (_triple_gen, ref_triple_gen)}
#: Forces the packed dynamics take after (params, x, u), per model.
FORCES = {"single": ("f_base", "f_mass"),
          "double": ("f_base", "f_mass", "f_mass_2"),
          "triple": ("f_base", "f_mass", "f_mass_2", "f_mass_3")}


def _states(sd, seed=0):
    """Random states (positions, angles in [-4, 4], rates) and controls."""
    rng = np.random.RandomState(seed)
    n_q = sd // 2
    scale = [1.0] + [4.0] * (n_q - 1) + [3.0] + [8.0] * (n_q - 1)
    x = rng.uniform(-1.0, 1.0, (sd, N)) * np.array(scale)[:, None]
    u = rng.uniform(-50.0, 50.0, N)
    return x, u


def _params(name, per_instance, seed=1):
    """The model's default params as numpy, each field scaled per instance
    by U(0.7, 1.3) with ``per_instance``."""
    d = {k: np.float64(v) for k, v in
         ct.get_model(name).default_params().as_dict().items()}
    if per_instance:
        rng = np.random.RandomState(seed)
        d = {k: v * rng.uniform(0.7, 1.3, N) for k, v in d.items()}
    return d


def _pair(name, d):
    """The port's and the reference's params from the same numpy dict."""
    port = params_from_numpy(d, device="cpu", model=pt.get_model(name))
    ref = ct.get_model(name).params_type(
        **{k: jnp.asarray(v) for k, v in d.items()})
    return port, ref


def _close(a, b):
    np.testing.assert_allclose(
        np.broadcast_to(np.asarray(a, np.float64), (N,)),
        np.broadcast_to(np.asarray(b, np.float64), (N,)), rtol=1e-12,
        atol=1e-12)


@pytest.mark.parametrize("per_instance", [False, True])
@pytest.mark.parametrize("name", ["double", "triple"])
def test_generated_cores_match_reference(name, per_instance):
    gen, ref_gen = GEN[name]
    model = pt.get_model(name)
    x, u = _states(model.state_dim, seed=2)
    d = _params(name, per_instance)
    p = tuple(torch.as_tensor(v) for v in d.values())
    p_r = tuple(jnp.asarray(v) for v in d.values())
    xr = tuple(torch.as_tensor(r) for r in x)
    core = getattr(gen, f"{name}_dynamics_core")(p, xr, torch.as_tensor(u))
    core_r = getattr(ref_gen, f"{name}_dynamics_core")(
        p_r, jnp.asarray(x), jnp.asarray(u))
    for a, b in zip(core, core_r, strict=True):
        _close(a, b)
    xd, jx, ju = getattr(gen, f"{name}_dynamics_jac_core")(
        p, xr, torch.as_tensor(u))
    xd_r, jx_r, ju_r = getattr(ref_gen, f"{name}_dynamics_jac_core")(
        p_r, jnp.asarray(x), jnp.asarray(u))
    for a, b in zip(xd, xd_r, strict=True):
        _close(a, b)
    for row, row_r in zip(jx, jx_r, strict=True):
        for a, b in zip(row, row_r, strict=True):
            _close(a, b)
    for a, b in zip(ju, ju_r, strict=True):
        _close(a, b)


def _force_cases(name):
    names = FORCES[name]
    return [c for n in range(len(names) + 1)
            for c in itertools.combinations(names, n)]


@pytest.mark.parametrize("name,forces", [
    (name, forces) for name in ("double", "triple")
    for forces in _force_cases(name)])
def test_packed_dynamics_matches_reference(name, forces):
    """``model.dynamics`` with every subset of its external forces: the
    double's closed form, the triple's generated core with the 8-entry
    force tuple."""
    model, ref_model = pt.get_model(name), ct.get_model(name)
    x, u = _states(model.state_dim, seed=3)
    dp, dp_r = _pair(name, _params(name, per_instance=True, seed=4))
    rng = np.random.RandomState(5)
    f = {k: rng.uniform(-5.0, 5.0, (2, N)) for k in forces}
    out = model.dynamics(dp, torch.as_tensor(x), torch.as_tensor(u),
                         **{k: torch.as_tensor(v) for k, v in f.items()})
    ref = ref_model.dynamics(dp_r, jnp.asarray(x), jnp.asarray(u),
                             **{k: jnp.asarray(v) for k, v in f.items()})
    assert tuple(out.shape) == (model.state_dim, N)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("name", ["single", "double", "triple"])
def test_energy_matches_reference(name):
    model = pt.get_model(name)
    x, _ = _states(model.state_dim, seed=6)
    dp, dp_r = _pair(name, _params(name, per_instance=True, seed=7))
    out = model.energy(dp, torch.as_tensor(x))
    ref = ct.get_model(name).energy(dp_r, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_energy_is_conserved_by_the_unforced_double():
    """The double pole has no dissipation: 100 RK4 steps of 1 ms with no
    control keep its energy to the integrator's error."""
    model = pt.DOUBLE_CARTPOLE
    dp = pt.default_double_params(torch.float64, device="cpu")
    x = torch.tensor([[0.0], [1.2], [2.0], [0.3], [1.0], [-2.0]],
                     dtype=torch.float64)
    e0 = model.energy(dp, x)
    u = torch.zeros(1, dtype=torch.float64)
    h = 1e-3
    for _ in range(100):
        k1 = model.dynamics(dp, x, u)
        k2 = model.dynamics(dp, x + 0.5 * h * k1, u)
        k3 = model.dynamics(dp, x + 0.5 * h * k2, u)
        k4 = model.dynamics(dp, x + h * k3, u)
        x = x + h / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    np.testing.assert_allclose(model.energy(dp, x).numpy(), e0.numpy(),
                               rtol=1e-9)


@pytest.mark.parametrize("name", ["single", "double", "triple"])
def test_registry_and_defaults_match_reference(name):
    model, ref = pt.get_model(name), ct.get_model(name)
    assert model.name == name
    assert model.state_dim == ref.state_dim
    assert model.angle_indices == ref.angle_indices
    assert getattr(pt, f"{name.upper()}_CARTPOLE") is model
    fields = [f.name for f in dataclasses.fields(model.params_type)]
    assert fields == [f.name for f in dataclasses.fields(ref.params_type)]
    dp = getattr(pt, f"default_{name}_params")(torch.float64, device="cpu")
    assert type(dp) is model.params_type
    for k, v in dp.as_dict().items():
        assert v.dtype == torch.float64 and v.device.type == "cpu"
        assert float(v) == float(getattr(ref.default_params(), k))


def test_unknown_model_raises():
    with pytest.raises(KeyError, match="available"):
        pt.get_model("quadruple")


@pytest.mark.parametrize("name", ["single", "double", "triple"])
def test_params_from_numpy_round_trip(name):
    """The reference's params as numpy (scalar and per-instance fields) go
    into the model's params type with their values, and back out."""
    model = pt.get_model(name)
    d = _params(name, per_instance=False)
    d[next(iter(d))] = np.linspace(0.9, 1.1, 4)
    dp = params_from_numpy(d, device="cpu", model=model)
    assert type(dp) is model.params_type
    assert dp.as_tuple() == tuple(dp.as_dict().values())
    for k, v in dp.as_dict().items():
        np.testing.assert_array_equal(v.numpy(), d[k])
    with pytest.raises(TypeError):
        params_from_numpy({**d, "k_extra": 1.0}, device="cpu", model=model)


def test_import_scan_covers_the_new_files():
    """``tests/test_torch_dynamics.py``'s scan for imports of jax or the JAX
    package walks the whole port, so it reads the new model, schedule and
    generated files, and finds nothing in them."""
    from test_torch_dynamics import _jax_refs

    new = ["models/double.py", "models/triple.py", "models/_double_gen.py",
           "models/_triple_gen.py", "mpc/schedule.py"]
    for rel in new:
        path = os.path.join(ROOT, "cartpole_tpu_torch", rel)
        assert os.path.exists(path)
        assert _jax_refs(path) == []
