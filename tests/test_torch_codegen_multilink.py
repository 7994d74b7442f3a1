"""The committed double and triple dynamics of the PyTorch port are what the
generator emits.

``python -m cartpole_tpu_torch.symbolic.generate --version double|triple``
derives the model from the port's copy of the SymPy derivation and emits the
torch module ``models/_<version>_gen.py`` and the CUDA header
``csrc/<version>_dynamics.cuh`` from one CSE. Each derivation runs once per
module (the double's takes about a minute). The headers share the single
header's ``dyn_*`` helpers and keep their constants in a namespace of their
own, so the three compile in one translation unit.
"""

import os

import pytest

pytest.importorskip("sympy")
pytest.importorskip("cartpole_tpu_torch")

from cartpole_tpu_torch.symbolic import generate

VERSIONS = ("double", "triple")


@pytest.fixture(scope="module")
def derived():
    return {v: generate.VERSIONS[v]() for v in VERSIONS}


@pytest.mark.parametrize("version", VERSIONS)
def test_torch_module_is_current(derived, version):
    with open(generate.outputs(version)[0]) as f:
        assert f.read() == generate.generate_torch_module(derived[version],
                                                          version)


@pytest.mark.parametrize("version", VERSIONS)
def test_cuda_header_is_current(derived, version):
    with open(generate.outputs(version)[1]) as f:
        header = f.read()
    assert header == generate.generate_cuda_header(derived[version], version)
    # Precise transcendentals from the single header, in the model's own
    # namespace.
    assert "__sinf(" not in header and "__cosf(" not in header
    assert '#include "single_dynamics.cuh"' in header
    assert f"namespace {version}_pole {{" in header
    assert "dyn_sin(" in header and "inline float dyn_sin" not in header


def test_command_line_writes_both_outputs(tmp_path, monkeypatch):
    """``main(["--version", "triple"])`` writes the triple's two outputs;
    the default version stays the single."""
    monkeypatch.setattr(generate, "outputs", lambda version="single": (
        str(tmp_path / f"_{version}_gen.py"),
        str(tmp_path / f"{version}_dynamics.cuh")))
    assert generate.main(["--version", "triple"]) == 0
    for ours, committed in zip(generate.outputs("triple"),
                               (os.path.join(os.path.dirname(
                                   generate.TORCH_OUT), "_triple_gen.py"),
                                os.path.join(os.path.dirname(
                                    generate.CUDA_OUT),
                                    "triple_dynamics.cuh"))):
        with open(ours) as a, open(committed) as b:
            assert a.read() == b.read()
    with pytest.raises(SystemExit):
        generate.main(["--version", "quadruple"])
