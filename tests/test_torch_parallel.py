"""The port's scenario-parallel layer (``cartpole_tpu_torch/parallel``).

* ``reduce_diagnostics`` on one ``NLSOutputs`` made from seeded numpy and
  given to both packages: the port's equals the JAX package's field for
  field (counts and maxima exactly; the means, f32 sums in both, to 1e-6).
* Two ranks under gloo on the CPU (``torch.multiprocessing.spawn``, a free
  port, 60 s) run ``make_sharded_closed_loop`` on the per-instance params
  grid of ``tests/test_parallel.py::TestShardedFused`` (n=8, f64), layouts
  ``lanes-fused`` and ``vmap``, as a balance problem whose solves take
  steps (window 10, spacing 2, soft terminal costs, from near upright; at
  that test's window 4 from hanging no step is accepted, in either
  package, so the controls would be the cold guess): the gathered
  results equal the unsharded run's with max |du| 0 and identical codes
  (the reference's own gate, ``tpu_gate.json``), and the all-reduced
  diagnostics equal the unsharded ones.
* ``initialize_distributed`` is a no-op without an opt-in signal and
  forwards explicit arguments; mesh helpers slice as documented.
"""

import dataclasses
import math
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import cartpole_tpu_torch as pt  # noqa: E402
from cartpole_tpu_torch import parallel  # noqa: E402
from cartpole_tpu_torch.ops.solver import NLSOutputs  # noqa: E402

N, TICKS = 8, 2
LAYOUTS = ("lanes-fused", "vmap")
UP = (0.0, math.pi / 2, 0.0, 0.0)


def _solver_outputs(B=16, iters=4, seed=0):
    """Field values of a batch's ``NLSOutputs``, as numpy: every code,
    failures and a NaN cost included."""
    rng = np.random.RandomState(seed)
    term = rng.randint(0, 5, B).astype(np.int32)
    return dict(
        termination_state=term,
        n_iterations=rng.randint(1, iters + 1, B).astype(np.int32),
        cost=np.where(np.arange(B) == 3, np.nan, rng.uniform(0, 50, B)),
        constraint_violation=rng.uniform(0, 1, B),
        first_order_norm=rng.uniform(0, 10, B),
        lambda_final=rng.uniform(0, 1, B),
        **{k: rng.uniform(0, 1, (B, iters)) for k in (
            "iter_cost", "iter_violation", "iter_lambda", "iter_step_size",
            "iter_first_order")},
    )


def test_reduce_diagnostics_matches_reference():
    import jax.numpy as jnp

    from cartpole_tpu.ops.solver import NLSOutputs as RefOutputs
    from cartpole_tpu.parallel import reduce_diagnostics as ref_reduce

    fields = _solver_outputs()
    ref = ref_reduce(RefOutputs(**{k: jnp.asarray(v)
                                   for k, v in fields.items()}))
    got = parallel.reduce_diagnostics(NLSOutputs(**{
        k: torch.as_tensor(v) for k, v in fields.items()}))
    for name in ("n_instances", "n_converged", "n_failed",
                 "termination_counts", "max_violation", "max_first_order"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(ref, name)), name)
    for name in ("mean_iterations", "mean_cost"):
        np.testing.assert_allclose(np.asarray(getattr(got, name)),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-6, err_msg=name)
    assert int(got.n_failed) == int(np.isin(fields["termination_state"],
                                            (3, 4)).sum())


def _problem():
    """The per-instance params grid of the reference's sharded lanes-fused
    test (each instance its own m_1 and l_1), balancing from near
    upright."""
    mpc = pt.make_mpc(pt.OptimizationParams(
        window_length=10, state_spacing=2, max_iterations=3,
        max_line_search_iterations=2, kkt_method="condensed",
        th_final_cost_weight=150.0, th_dot_final_cost_weight=10.0,
        b_x_dot_final_cost_weight=10.0, u_guess_sinusoid_amplitude=0.0))
    base = pt.default_single_params(torch.float64, device="cpu")
    grid = dataclasses.replace(
        pt.SingleCartPoleParams(**{k: v.expand(N).clone()
                                   for k, v in base.as_dict().items()}),
        m_1=torch.linspace(0.08, 0.15, N, dtype=torch.float64),
        l_1=torch.linspace(0.2, 0.35, N, dtype=torch.float64))
    rng = np.random.RandomState(5)
    x0s = np.tile(UP, (N, 1))
    x0s[:, 1] += rng.uniform(-0.2, 0.2, N)
    return mpc, torch.as_tensor(x0s), grid, torch.zeros(N,
                                                        dtype=torch.float64)


def _run_layouts(mesh):
    """Each layout's (controls, codes, final state, diagnostics), gathered
    from every rank."""
    mpc, x0s, grid, sps = _problem()
    out = {}
    for layout in LAYOUTS:
        run = parallel.make_sharded_closed_loop(
            mpc, mesh, TICKS, batched_params=True, layout=layout)
        res, diag = run(*parallel.shard_scenarios((x0s, grid, sps), mesh))
        out[layout] = parallel.gather_scenarios(
            (res.controls, res.termination_states, res.final_state), mesh
        ) + (diag,)
    return out


def _rank_worker(rank, port, path):
    torch.set_num_threads(1)
    parallel.initialize_distributed(f"tcp://127.0.0.1:{port}", world_size=2,
                                    rank=rank, backend="gloo")
    try:
        out = _run_layouts(parallel.make_scenario_mesh(device="cpu"))
        if rank == 0:
            torch.save(out, path)
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ranks") / "out.pt")
    ctx = mp.spawn(_rank_worker, args=(_free_port(), path), nprocs=2,
                   join=False)
    deadline = time.monotonic() + 60.0
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError("two-rank run exceeded 60 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return torch.load(path, weights_only=False)


@pytest.fixture(scope="module")
def one_rank():
    return _run_layouts(parallel.make_scenario_mesh(device="cpu"))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_two_ranks_equal_one(two_ranks, one_rank, layout):
    (u2, c2, x2, d2), (u1, c1, x1, d1) = two_ranks[layout], one_rank[layout]
    assert u2.shape == (N, TICKS) and torch.isfinite(u2).all()
    assert float((u2 - u1).abs().max()) == 0.0
    assert torch.equal(c2, c1)
    assert torch.equal(x2, x1)
    assert int(d2.n_instances) == N
    assert not torch.allclose(u2[0], u2[-1])  # the solves took steps
    for name, v in d1._asdict().items():
        assert torch.equal(torch.as_tensor(getattr(d2, name)),
                           torch.as_tensor(v)) or (
            torch.isnan(torch.as_tensor(v)).all()
            and torch.isnan(torch.as_tensor(getattr(d2, name))).all()), name


def test_initialize_distributed_opt_in(monkeypatch):
    seen = {}

    def fake_init(backend=None, **kw):
        seen.update(kw, backend=backend)

    def boom(*a, **kw):  # pragma: no cover - must not be called
        raise AssertionError("init_process_group called without opt-in")

    for var in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(dist, "init_process_group", boom)
    parallel.initialize_distributed()
    parallel.initialize_distributed(world_size=1, rank=0)
    monkeypatch.setattr(dist, "init_process_group", fake_init)
    parallel.initialize_distributed("tcp://127.0.0.1:1", world_size=2,
                                    rank=1, backend="gloo")
    assert seen == dict(init_method="tcp://127.0.0.1:1", world_size=2,
                        rank=1, backend="gloo")
    seen.clear()
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    parallel.initialize_distributed()
    assert seen["backend"] in ("gloo", "nccl")


def test_mesh_helpers():
    mesh = parallel.ScenarioMesh(world_size=4, rank=2,
                                 device=torch.device("cpu"))
    assert parallel.host_local_batch(8, mesh) == 2
    with pytest.raises(ValueError, match="not divisible"):
        parallel.host_local_batch(10, mesh)
    assert parallel.scenario_sharding(mesh, 8) == slice(4, 6)
    assert parallel.replicated_sharding(mesh) == slice(None)
    x, p = parallel.shard_scenarios(
        (np.arange(8.0), {"m": torch.arange(8)}), mesh)
    assert x.tolist() == [4.0, 5.0] and p["m"].tolist() == [4, 5]
    single = parallel.make_scenario_mesh(device="cpu")
    assert (single.world_size, single.rank, single.group) == (1, 0, None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.make_scenario_mesh()


def test_sharded_step_diagnostics_cover_the_batch():
    mpc, x0s, grid, sps = _problem()
    mesh = parallel.make_scenario_mesh(device="cpu")
    states = pt.MPCState(torch.zeros(N, mpc.spec.dim, dtype=torch.float64),
                         torch.zeros(N, dtype=torch.bool))
    for layout in ("vmap", "lanes", "lanes-fused"):
        step = parallel.make_sharded_step(mpc, mesh, batched_params=True,
                                          layout=layout)
        out, new, diag = step(states, x0s, grid, sps)
        assert out.u.shape == (N, 10) and bool(new.warm.all())
        assert int(diag.n_instances) == N
        assert int(diag.termination_counts.sum()) == N
        assert float(diag.mean_iterations) > 0
    with pytest.raises(ValueError, match="unknown layout"):
        parallel.make_sharded_step(mpc, mesh, layout="pmap")
