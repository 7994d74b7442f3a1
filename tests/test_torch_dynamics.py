"""Generated torch dynamics of the PyTorch port against the JAX package.

``cartpole_tpu_torch/models/_single_gen.py`` and ``csrc/single_dynamics.cuh``
are emitted from one CSE of the port's copy of the SymPy derivation; here
the torch functions are held against ``cartpole_tpu/models/_single_gen.py``
in f64 on random states, to 1e-12, the committed outputs against a fresh
generation, and the port's copy of the derivation against the JAX
package's file. No module of the port, and not ``chip_smoke.py``, imports
JAX or the JAX package or builds a path into it.
"""

import ast
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

import jax.numpy as jnp

from cartpole_tpu.models import _single_gen as ref_gen
from cartpole_tpu_torch.models import _single_gen as gen
from cartpole_tpu_torch.models.base import get_model
from cartpole_tpu_torch.models.params import default_single_params
from cartpole_tpu_torch.symbolic import generate, lagrangian

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
        get_model("quadruple")


def test_generated_files_are_current():
    """The committed torch module and CUDA header are what the generator
    emits from the port's copy of the derivation today."""
    model = lagrangian.derive_single_cartpole()
    with open(generate.TORCH_OUT) as f:
        assert f.read() == generate.generate_torch_module(model)
    with open(generate.CUDA_OUT) as f:
        header = f.read()
    assert header == generate.generate_cuda_header(model)
    # Precise transcendentals only: no fast-math intrinsics.
    assert "__sinf(" not in header and "__cosf(" not in header


def test_port_lagrangian_matches_the_reference():
    """The port's copy of the derivation and the JAX package's file give the
    same generated sources. The only place the reference file is loaded (by
    path: its package would import jax)."""
    path = os.path.join(ROOT, "cartpole_tpu", "symbolic", "lagrangian.py")
    spec = importlib.util.spec_from_file_location("_ref_lagrangian", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    ours = lagrangian.derive_single_cartpole()
    theirs = ref.derive_single_cartpole()
    assert generate.generate_torch_module(ours) == \
        generate.generate_torch_module(theirs)
    assert generate.generate_cuda_header(ours) == \
        generate.generate_cuda_header(theirs)


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


def _docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value,
                                                          ast.Constant):
                yield first.value


def _replaces_values(tree):
    """The "replaces" entries of chip_smoke.py's kernel line: names of the
    TPU kernels, not paths the port opens."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "replaces":
                    yield v


def _jax_refs(path):
    """Imports of jax or of the JAX package, and strings that name it as a
    module or build a path into it, in one file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    skip = {id(n) for n in _docstrings(tree)} | {
        id(n) for n in _replaces_values(tree)}
    out = []

    def bad(name):
        root = name.split(".")[0]
        return root in ("jax", "jaxlib", "cartpole_tpu")

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names if bad(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and bad(node.module):
                out.append(node.module)
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and id(node) not in skip and not any(
                  c.isspace() for c in node.value)):
            v = node.value
            if v in ("jax", "cartpole_tpu") or v.startswith(
                    ("jax.", "cartpole_tpu.", "cartpole_tpu/")):
                out.append(repr(v))
    return out


def test_port_never_reaches_the_jax_package(tmp_path):
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "cartpole_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    # The entry points and their subpackages are scanned too.
    scanned = {os.path.relpath(f, os.path.join(ROOT, "cartpole_tpu_torch"))
               for f in files}
    for need in ("cli.py", "__main__.py", "pypendulum.py", "analysis.py",
                 "viz.py", "parallel/mesh.py", "parallel/sharded.py",
                 "utils/logging.py", "utils/replay.py", "utils/tracing.py",
                 "utils/checkpoint.py", "utils/debug.py",
                 "utils/roofline.py", "interactive.py", "web/__init__.py",
                 "web/server.py", "web/page.py"):
        assert need in scanned, need
    found = {os.path.relpath(f, ROOT): r for f in files
             if (r := _jax_refs(f))}
    assert not found
    # The scan sees what it looks for.
    probe = tmp_path / "probe.py"
    probe.write_text(
        '"""Docstrings may name cartpole_tpu/ops/fused.py."""\n'
        "import jax.numpy\n"
        "from cartpole_tpu.ops import fused\n"
        "path = os.path.join(root, 'cartpole_tpu', 'symbolic')\n"
        "line = {'replaces': 'cartpole_tpu/ops/fused.py:938'}\n")
    assert _jax_refs(str(probe)) == ["jax.numpy", "cartpole_tpu.ops",
                                     "'cartpole_tpu'"]
