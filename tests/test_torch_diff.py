"""Differentiable MPC (``cartpole_tpu_torch/diff.py``) against the JAX
package's (``cartpole_tpu/diff.py``), in f64 at the reference's calibrated
points (``tests/test_diff.py``'s ``_small_mpc``: window 20, spacing 5, 20 GN
iterations, no sinusoid; ``x0 = [0.1, pi/2 + 0.15, -0.05, 0.1]``).

* The ``"ift"`` and ``"unrolled"`` gradients at the interior point, with
  respect to the state, ``m_1`` and the set point: within 1e-7 of the
  largest reference component of each; ``"ift"`` also within
  ``tests/test_diff.py``'s rtol 2e-4 (atol 1e-7) of central differences in
  the state, ``m_b``, ``m_1``, ``l_1`` and the set point.
* The saturated stall of ``tests/test_diff_saturation.py`` (``u_limit`` 31,
  60 iterations): the ``"unrolled"`` gradient (reverse mode in the port,
  forward mode in the reference) within 1e-7 of the reference's, and within
  rtol 1e-3 of central differences in the state and ``m_1``.
* The clamped case (``u_limit`` 25, 40 iterations): no ``"ift"`` gradient
  flows through a clamped control, and every value is finite.
* ``with_diagnostics`` at the interior point and at the stall: the active
  set, its size and the termination code equal the reference's. The
  gradients above are taken by ``.backward()``; the tests below take them
  by ``torch.func.grad`` and ``torch.func.vmap`` too.
* The warm start's gradient is zero; ``torch.func.vmap(torch.func.grad)``
  rows equal the unbatched gradients (rtol 1e-10); ``.backward()`` gives
  ``torch.func.grad``'s gradient.
* ``tools/sysid.py``'s loss at a tiny size (window 10, 2 states): its
  gradient in ``(m_1, l_1)`` within rtol 1e-7 of ``jax.grad`` of the same
  loss built from the JAX package, and two Adam steps stay finite.

The JAX package's programs run in fresh interpreters (this file run as a
script, one process per group, started together when the module's first
test asks): its large second-order programs can corrupt XLA:CPU's heap in a
process that has already run others (``tests/test_diff_saturation.py``'s
docstring), and a pytest worker runs many files. The sysid group's results
serve ``tests/test_torch_diff_graph.py`` too: :class:`SharedReference`
runs its interpreter once per test run, whichever file asks first.
"""

import dataclasses
import fcntl
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")

X0 = [0.1, math.pi / 2 + 0.15, -0.05, 0.1]
SMALL = dict(max_iterations=20, window_length=20, state_spacing=5,
             u_guess_sinusoid_amplitude=0.0)
STALL = dict(SMALL, u_limit=31.0, max_iterations=60)
CLAMPED = dict(SMALL, u_limit=25.0, max_iterations=40)
#: Every dynamics parameter of the single pole, in the dataclass's order.
FIELDS = ("m_b", "m_1", "l_1", "g", "mu_b", "v_mu_b", "c_d_1", "x_s", "k_s")
#: tools/sysid.py at a tiny size.
SYSID_WINDOW, SYSID_STATES = 10, 2
#: The JAX package's programs, one interpreter each: the interior point's
#: two methods, the stall's "unrolled", the sysid loss.
GROUPS = ("ift", "unrolled", "stall", "sysid")


def _loss_of(z, u_start, sd):
    """``tests/test_diff.py::test_wrt_initial_state``'s loss, over the
    controls and the first two shooting states."""
    return (z[u_start:] ** 2).sum() + 10.0 * ((z[:2 * sd] - 0.3) ** 2).sum()


# ------------------------------------------------- the JAX package's side
def _reference(group):
    """The JAX package's results of one of ``GROUPS``, as lists (run in its
    own interpreter, ``python tests/test_torch_diff.py GROUP``): the
    gradient of ``_loss_of`` in (x, ``m_1``, the set point) at X0 and the
    diagnostics, or the sysid loss's gradient."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import cartpole_tpu as ct
    from cartpole_tpu.diff import make_differentiable_solve

    def mpc_of(kw):
        return ct.make_mpc(ct.OptimizationParams(**kw), ct.get_model("single"))

    def cold(mpc):
        return ct.MPCState(jnp.zeros((mpc.spec.dim,)), jnp.zeros((), bool))

    dp = ct.default_single_params(jnp.float64)
    if group == "sysid":
        mpc = mpc_of(dict(SMALL, window_length=SYSID_WINDOW))
        spec, state = mpc.spec, cold(mpc)
        solve = make_differentiable_solve(mpc)
        xs = jnp.asarray(_sysid_states())

        def plans(d):
            return jax.vmap(lambda x: solve(x, d, 0.0, state)[spec.u_start:])(
                xs)

        truth = dataclasses.replace(dp, m_1=0.16, l_1=0.31)
        u_data = jax.jit(plans)(truth)

        def sysid_loss(v):
            return jnp.mean((plans(dataclasses.replace(
                dp, m_1=v[0], l_1=v[1])) - u_data) ** 2)

        value, g = jax.jit(jax.value_and_grad(sysid_loss))(
            jnp.asarray([0.10, 0.25]))
        return {"grad": np.asarray(g).tolist(), "value": float(value)}

    mpc = mpc_of(STALL if group == "stall" else SMALL)
    spec, state = mpc.spec, cold(mpc)
    solve = make_differentiable_solve(
        mpc, with_diagnostics=True,
        method="ift" if group == "ift" else "unrolled")

    def loss(x, m1, sp):
        z, diag = solve(x, dataclasses.replace(dp, m_1=m1), sp, state)
        return _loss_of(z, spec.u_start, spec.state_dim), diag

    (gx, gm, gsp), diag = jax.jit(jax.grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
            jnp.asarray(X0, jnp.float64), dp.m_1, 0.0)
    return dict(x=np.asarray(gx).tolist(), m_1=float(gm), sp=float(gsp),
                diag=dict(active=np.asarray(diag["active"]).tolist(),
                          n_active=int(diag["n_active"]),
                          termination_state=int(diag["termination_state"])))


def _sysid_states():
    from cartpole_tpu_torch.tools.sysid import excitation_states

    return excitation_states()[:SYSID_STATES]


def _start(group):
    """``group``'s interpreter, started."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # One thread each: the programs are compile-bound, and the pytest
    # workers share the cores.
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", XLA_FLAGS=(
                   "--xla_cpu_multi_thread_eigen=false "
                   "intra_op_parallelism_threads=1"),
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return subprocess.Popen([sys.executable, __file__, group], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _results(proc):
    """What a started interpreter printed last, parsed."""
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def _stop(proc):
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.communicate()


class SharedReference:
    """``group``'s results, computed once per test run for every test file
    and pytest worker that asks. They go to a file in the run's temporary
    directory (under xdist, the workers' common parent), written under an
    exclusive lock: the first to ask takes the lock, starts the group's
    interpreter at once and holds the lock until it has written the file; a
    later one waits on the lock and reads the file, or runs the group
    itself if the first one failed."""

    def __init__(self, group, tmp_path_factory):
        root = tmp_path_factory.getbasetemp()
        if os.environ.get("PYTEST_XDIST_WORKER"):
            root = root.parent
        self.group, self.proc = group, None
        self.path = root / f"torch_diff_reference_{group}.json"
        self.lock = open(root / f"torch_diff_reference_{group}.lock", "a")
        try:
            fcntl.flock(self.lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:
            return  # another worker is running it
        if self.path.exists():
            fcntl.flock(self.lock, fcntl.LOCK_UN)
        else:
            self.proc = _start(group)

    def get(self):
        if self.proc is None:
            fcntl.flock(self.lock, fcntl.LOCK_EX)
            if self.path.exists():
                fcntl.flock(self.lock, fcntl.LOCK_UN)
                return json.loads(self.path.read_text())
            self.proc = _start(self.group)
        try:
            result = _results(self.proc)
            part = self.path.with_suffix(".part")
            part.write_text(json.dumps(result))
            part.replace(self.path)
            return result
        finally:
            self.proc = None
            fcntl.flock(self.lock, fcntl.LOCK_UN)

    def close(self):
        _stop(self.proc)
        self.lock.close()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``reference(group)``: the JAX package's results of ``group``; all
    groups' interpreters start when the fixture is first used (the sysid
    group's unless another file has started it)."""
    procs = {g: _start(g) for g in GROUPS if g != "sysid"}
    sysid_ref = SharedReference("sysid", tmp_path_factory)
    results = {}

    def get(group):
        if group not in results:
            results[group] = (sysid_ref.get() if group == "sysid"
                              else _results(procs[group]))
        return results[group]

    yield get
    for proc in procs.values():
        _stop(proc)
    sysid_ref.close()


# ---------------------------------------------------------- the port's side
import cartpole_tpu_torch as pt  # noqa: E402
from cartpole_tpu_torch import make_differentiable_solve  # noqa: E402
from cartpole_tpu_torch.tools import sysid  # noqa: E402

F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    the pytest workers share the cores (batched solves ran 5-10x slower
    with the default thread count under a loaded tier-1 run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mpc(kw):
    return pt.make_mpc(pt.OptimizationParams(**kw))


def _dp():
    return pt.default_single_params(F64, device="cpu")


def _x0():
    return torch.tensor(X0, dtype=F64)


def _grads(mpc, method):
    """The port's gradient of ``_loss_of`` in (x, the dynamics parameters,
    the set point) at X0 from cold, by ``.backward()``, and the solve's
    diagnostics."""
    spec = mpc.spec
    solve = make_differentiable_solve(mpc, with_diagnostics=True,
                                      method=method)
    x = _x0().requires_grad_()
    sp = torch.zeros((), dtype=F64, requires_grad=True)
    dp = pt.SingleCartPoleParams(*(v.clone().requires_grad_()
                                   for v in _dp().as_tuple()))
    z, diag = solve(x, dp, sp, mpc.init_state(F64, "cpu"))
    _loss_of(z, spec.u_start, spec.state_dim).backward()
    return dict(x=x.grad.numpy(),
                dp=np.array([float(v.grad) for v in dp.as_tuple()]),
                m_1=float(dp.m_1.grad), sp=float(sp.grad), diag=diag)


def _fd(mpc, names, eps=1e-6):
    """Central differences of ``_loss_of`` in the named coordinates of
    theta = (x (4), the dynamics parameters, the set point): every
    perturbed solve in one ``torch.func.vmap`` of the forward."""
    spec = mpc.spec
    solve = make_differentiable_solve(mpc)
    state = mpc.init_state(F64, "cpu")
    dp = _dp()
    coords = [f"x{i}" for i in range(4)] + list(FIELDS) + ["sp"]
    theta0 = torch.cat([_x0(), torch.stack(dp.as_tuple()),
                        torch.zeros(1, dtype=F64)])
    steps = torch.zeros((2 * len(names), theta0.numel()), dtype=F64)
    for j, name in enumerate(names):
        steps[2 * j, coords.index(name)] = eps
        steps[2 * j + 1, coords.index(name)] = -eps

    def loss(theta):
        d = pt.SingleCartPoleParams(*theta[4:4 + len(FIELDS)])
        z = solve(theta[:4], d, theta[-1], state)
        return _loss_of(z, spec.u_start, spec.state_dim)

    with torch.no_grad():
        vals = torch.func.vmap(loss)(theta0 + steps).numpy()
    return (vals[0::2] - vals[1::2]) / (2 * eps)


def _close(g, g_ref, rel=1e-7):
    """Within ``rel`` of the largest reference component."""
    g_ref = np.asarray(g_ref, np.float64)
    np.testing.assert_allclose(g, g_ref, rtol=0,
                               atol=rel * np.max(np.abs(g_ref)))


@pytest.fixture(scope="module")
def interior(reference):
    mpc = _mpc(SMALL)
    return mpc, {m: _grads(mpc, m) for m in ("ift", "unrolled")}


@pytest.fixture(scope="module")
def stall(reference):
    mpc = _mpc(STALL)
    return mpc, _grads(mpc, "unrolled")


@pytest.mark.parametrize("method", ["ift", "unrolled"])
def test_interior_gradient_matches_reference(interior, reference, method):
    _, port = interior
    ref = reference(method)
    for key in ("x", "m_1", "sp"):
        _close(port[method][key], ref[key])


def test_ift_gradient_matches_finite_differences(interior):
    mpc, port = interior
    names = ["x0", "x1", "x2", "x3", "m_b", "m_1", "l_1", "sp"]
    g = port["ift"]
    g_port = np.r_[g["x"], g["dp"][:3], g["sp"]]
    np.testing.assert_allclose(g_port, _fd(mpc, names), rtol=2e-4, atol=1e-7)


def test_stall_unrolled_matches_reference(stall, reference):
    _, port = stall
    ref = reference("stall")
    for key in ("x", "m_1", "sp"):
        _close(port[key], ref[key])


def test_stall_unrolled_matches_finite_differences(stall):
    """``tests/test_diff_saturation.py::test_unrolled_fd_exact_under_
    saturation``: reverse mode through 60 iterations of ratcheting damping
    and rejected trials gives the algorithm's derivative, NaN-free."""
    mpc, port = stall
    fd = _fd(mpc, ["x0", "x1", "x2", "x3", "m_1"])
    np.testing.assert_allclose(port["x"], fd[:4], rtol=1e-3)
    np.testing.assert_allclose(port["m_1"], fd[4], rtol=1e-3)


def test_ift_clamped_control_carries_no_gradient():
    """``tests/test_diff_saturation.py::test_clamped_gradient_finite_and_
    blocked``: one solve, two backward passes through it."""
    mpc = _mpc(CLAMPED)
    spec = mpc.spec
    x = _x0().requires_grad_()
    solve = make_differentiable_solve(mpc)
    u = solve(x, _dp(), 0.0, mpc.init_state(F64, "cpu"))[spec.u_start:]
    clamped = torch.abs(u.detach()) >= 25.0 - 1e-6
    assert int(clamped.sum()) >= 2, "the case needs binding bounds"
    i = int(torch.argmax(clamped.to(torch.int32)))
    (g,) = torch.autograd.grad(torch.sum(u ** 2), x, retain_graph=True)
    (g_sat,) = torch.autograd.grad(u[i] ** 2, x)
    assert torch.isfinite(g).all() and torch.isfinite(g_sat).all()
    assert torch.any(g != 0)
    assert torch.all(torch.abs(g_sat) <= 1e-8 * torch.abs(g).max()), g_sat


@pytest.mark.parametrize("point", ["interior", "stall"])
def test_diagnostics_match_reference(request, reference, point):
    _, port = request.getfixturevalue(point)
    diag = (port["ift"] if point == "interior" else port)["diag"]
    ref = reference("ift" if point == "interior" else "stall")["diag"]
    assert diag["active"].dtype == torch.bool
    np.testing.assert_array_equal(diag["active"].numpy(), ref["active"])
    assert int(diag["n_active"]) == ref["n_active"]
    assert int(diag["termination_state"]) == ref["termination_state"]
    assert (ref["n_active"] >= 2) == (point == "stall")


def test_warm_start_gets_zero_gradient():
    """The warm start selects the basin and takes no gradient, through
    ``torch.func.grad`` and through ``.backward()``."""
    mpc = _mpc(SMALL)
    spec, dp, x0 = mpc.spec, _dp(), _x0()
    solve = make_differentiable_solve(mpc)
    z_prev = solve(x0, dp, 0.0, mpc.init_state(F64, "cpu"))

    def loss(x, prev):
        st = pt.MPCState(prev, torch.ones((), dtype=torch.bool))
        return torch.sum(solve(x, dp, 0.0, st)[spec.u_start:] ** 2)

    gx, gprev = torch.func.grad(loss, argnums=(0, 1))(x0, z_prev)
    assert torch.all(gprev == 0) and torch.isfinite(gx).all()
    x, prev = x0.clone().requires_grad_(), z_prev.clone().requires_grad_()
    loss(x, prev).backward()
    assert torch.all(prev.grad == 0)
    np.testing.assert_array_equal(x.grad.numpy(), gx.numpy())


def test_vmap_of_grad_matches_rows():
    mpc = _mpc(SMALL)
    spec, dp = mpc.spec, _dp()
    state = mpc.init_state(F64, "cpu")
    solve = make_differentiable_solve(mpc)
    xs = torch.stack([_x0(), _x0() + torch.tensor([0.05, -0.1, 0.02, 0.0],
                                                  dtype=F64)])

    def loss(x):
        return torch.sum(solve(x, dp, 0.0, state)[spec.u_start:] ** 2)

    gs = torch.func.vmap(torch.func.grad(loss))(xs)
    assert torch.isfinite(gs).all()
    for i in range(2):
        np.testing.assert_allclose(gs[i].numpy(),
                                   torch.func.grad(loss)(xs[i]).numpy(),
                                   rtol=1e-10)


def test_sysid_loss_gradient_and_adam(reference):
    mpc = sysid.make_mpc_for(SYSID_WINDOW)
    base = _dp()
    xs = torch.as_tensor(_sysid_states(), dtype=F64)
    plans = sysid.make_plans(mpc, xs)
    with torch.no_grad():
        u_data = plans(sysid.with_fit(base, torch.tensor(sysid.TRUE_VALUES,
                                                         dtype=F64)))
    loss = sysid.make_loss(plans, base, u_data)
    v0 = torch.tensor(sysid.INITIAL_VALUES, dtype=F64)
    g = torch.func.grad(loss)(v0)
    np.testing.assert_allclose(g.numpy(), reference("sysid")["grad"],
                               rtol=1e-7)
    v, losses = sysid.fit(loss, v0, 2)
    assert torch.isfinite(v).all() and np.isfinite(losses).all()
    assert len(losses) == 2 and not torch.equal(v, v0)


if __name__ == "__main__":
    print(json.dumps(_reference(sys.argv[1])))
