"""The differentiable solve made to be replayed (``diff.py::graphed``), on
the CPU at ``tests/test_torch_diff.py``'s tiny sysid size (window 10, 2
states, f64).

On the card ``tools/sysid.py::fit`` captures ``grad_and_value(loss)`` once
in a CUDA graph and replays it at every step, as the JAX example runs
``jax.jit(jax.value_and_grad(loss_fn))``. Here:

* ``graphed`` is ``fn`` itself on the CPU;
* ``fit`` through a stand-in for the graph (which replays by running
  ``fn`` on the graph's inputs) makes one capture and gives the eager
  ``fit``'s losses and ``v`` bit for bit over 3 steps; a failed capture
  raises;
* after a first call, a second gradient, ``"ift"`` or ``"unrolled"``, makes
  no tensor from host data (a capture forbids copies from the host);
* the port's ``grad_and_value`` of the sysid loss equals the JAX
  example's ``jax.value_and_grad(loss_fn)`` to rtol 1e-9, both from the
  sysid group of ``tests/test_torch_diff.py``'s reference interpreter,
  which runs once for both files.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")
#: tests/test_torch_diff.py: the tiny sysid size, its shared reference
#: interpreter and its one-thread fixture (autouse here too).
td = pytest.importorskip("test_torch_diff")
one_thread = td.one_thread

import cartpole_tpu_torch as pt  # noqa: E402
from cartpole_tpu_torch import diff  # noqa: E402
from cartpole_tpu_torch.mpc import closed_loop as cl  # noqa: E402
from cartpole_tpu_torch.tools import sysid  # noqa: E402

F64 = torch.float64
STEPS = 3


class _StubGraph(cl.CUDAGraphTick):
    """``CUDAGraphTick`` on the CPU: the warm-up runs ``fn`` as the card's
    would, the capture takes buffers for the outputs, and a replay runs
    ``fn`` on the graph's inputs and copies its results into them."""

    def _warm_up(self, fn, args):
        return fn(*args)

    def _capture(self, fn):
        self.outputs = tuple(o.clone() for o in self.warmup_outputs)

        def replay():
            for dst, src in zip(self.outputs, fn(*self.inputs)):
                dst.copy_(src)

        self.graph = type("Graph", (), {"replay": staticmethod(replay),
                                        "instantiate": lambda self: None})()
        return 0


def _sysid_loss(method="ift"):
    """``tools/sysid.py``'s loss at the tiny size, its solve's backward
    ``method``."""
    mpc = sysid.make_mpc_for(td.SYSID_WINDOW)
    base = pt.default_single_params(F64, device="cpu")
    xs = torch.as_tensor(td._sysid_states(), dtype=F64)
    if method == "ift":
        plans = sysid.make_plans(mpc, xs)
    else:
        solve = diff.make_differentiable_solve(mpc, method=method)
        cold, u_start = mpc.init_state(F64, "cpu"), mpc.spec.u_start

        def plans(dp):
            return torch.func.vmap(
                lambda x: solve(x, dp, 0.0, cold)[u_start:])(xs)

    with torch.no_grad():
        u_data = plans(sysid.with_fit(base, torch.tensor(sysid.TRUE_VALUES,
                                                         dtype=F64)))
    return sysid.make_loss(plans, base, u_data)


def _v0():
    return torch.tensor(sysid.INITIAL_VALUES, dtype=F64)


@pytest.fixture(scope="module")
def loss():
    return _sysid_loss()


@pytest.fixture(scope="module")
def eager_fit(loss):
    return sysid.fit(loss, _v0(), STEPS)


@pytest.fixture(scope="module")
def first_value_and_grad(loss):
    """``grad_and_value(loss)`` at the fit's start, the module's first."""
    return torch.func.grad_and_value(loss)(_v0())


def _stub_graphs(monkeypatch, cls=_StubGraph):
    made = []
    monkeypatch.setattr(diff, "_replays", lambda args: True)
    monkeypatch.setattr(diff, "CUDAGraphTick", lambda fn, args: made.append(
        cls(fn, args)) or made[-1])
    return made


def test_graphed_is_fn_on_the_cpu():
    def fn(v):
        return (2 * v,)

    assert diff.graphed(fn, (_v0(),)) is fn


def test_fit_through_the_graph_is_the_eager_fit(monkeypatch, loss,
                                                eager_fit):
    made = _stub_graphs(monkeypatch)
    v, losses = sysid.fit(loss, _v0(), STEPS)
    assert len(made) == 1  # one capture, replayed at every step
    v_eager, losses_eager = eager_fit
    assert losses == losses_eager
    assert torch.equal(v, v_eager)
    assert not torch.equal(v, _v0())


def test_fit_a_failed_capture_raises(monkeypatch, loss):
    class Broken(_StubGraph):
        def _warm_up(self, fn, args):
            return None

        def _capture(self, fn):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    _stub_graphs(monkeypatch, Broken)
    with pytest.raises(RuntimeError, match="capturing"):
        sysid.fit(loss, _v0(), STEPS)


@pytest.mark.parametrize("method", ["ift", "unrolled"])
def test_second_gradient_makes_no_tensor_from_host_data(
        monkeypatch, loss, first_value_and_grad, method):
    """What is made once (the problem's statics, the ``"ift"`` backward's
    scatter maps) is made by the first call; the second, which a capture
    would record, copies nothing from the host. The ``"unrolled"``
    backward is a reverse pass through the recomputed solve, so its first
    call is the data's solve, without a gradient."""
    f = loss if method == "ift" else _sysid_loss(method)
    value_and_grad, v0 = torch.func.grad_and_value(f), _v0()
    real = {name: getattr(torch, name) for name in ("as_tensor", "tensor")}

    def guarded(name):
        def make(data, *args, **kwargs):
            assert isinstance(data, torch.Tensor), (
                f"torch.{name} of host data {data!r}")
            return real[name](data, *args, **kwargs)
        return make

    for name in real:
        monkeypatch.setattr(torch, name, guarded(name))
    second = value_and_grad(v0)
    monkeypatch.undo()
    assert all(torch.isfinite(t).all() for t in second)
    if method == "ift":
        for a, b in zip(first_value_and_grad, second):
            assert torch.equal(a, b)


@pytest.fixture(scope="module", autouse=True)
def sysid_reference(tmp_path_factory):
    """Started with the module's first test, unless another file's test
    has started it."""
    ref = td.SharedReference("sysid", tmp_path_factory)
    yield ref.get
    ref.close()


def test_sysid_value_and_grad_match_the_jax_example(first_value_and_grad,
                                                    sysid_reference):
    g, value = first_value_and_grad
    ref = sysid_reference()
    np.testing.assert_allclose(g.numpy(), ref["grad"], rtol=1e-9)
    np.testing.assert_allclose(float(value), ref["value"], rtol=1e-9)
