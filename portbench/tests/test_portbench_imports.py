"""Nothing of the benchmark imports JAX or the JAX package
(``cartpole_tpu``), compared by whole top-level name, since the port's
name begins with the JAX package's; the reference imports nothing of the
port either."""

import ast
import os
import subprocess
import sys

import pytest

from conftest import ROOT

PB = os.path.join(ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "cartpole_tpu"}
FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(PB) for f in fs
               if f.endswith(".py"))


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, PB))
def test_no_jax(path):
    assert not FORBIDDEN & set(top_level_imports(path))


@pytest.mark.parametrize(
    "path", [p for p in FILES if os.sep + "reference" + os.sep in p],
    ids=lambda p: os.path.relpath(p, PB))
def test_reference_imports_nothing_of_the_port(path):
    assert "cartpole_tpu_torch" not in set(top_level_imports(path))
    assert "portbench" not in set(top_level_imports(path))


def test_a_run_loads_no_jax():
    """The harness, the drivers, the reference and the port, imported as
    a run imports them: no forbidden top-level name in ``sys.modules``."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import cartpole_tpu_torch\n"
        "import cartpole_tpu_torch.mpc.lanes\n"
        "from portbench import harness, control, count, readings\n"
        "from portbench.drivers import lanes_fleet\n"
        "import portbench.reference.mpc.lanes\n"
        "print(harness.forbidden_modules())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=dict(
                             os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_guard_catches_the_jax_package(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "cartpole_tpu.ops", object())
    assert harness.forbidden_modules() == ["cartpole_tpu.ops"]
    with pytest.raises(SystemExit):
        harness.guard()
    monkeypatch.delitem(sys.modules, "cartpole_tpu.ops")
    monkeypatch.setitem(sys.modules, "cartpole_tpu_torch_x", object())
    assert harness.forbidden_modules() == []
