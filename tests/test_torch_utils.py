"""The port's ``utils/`` against the JAX package's, and the params JSON.

* ``solve_log_entry`` of one f64 solve in each package from the same state
  (window 10, spacing 2, one jitted reference program shared by the
  module): the same JSON keys, numbers within 1e-10, nulls alike.
* A ``SolveLog`` saved by the JAX package, read by the port's
  ``replay_log``, gives the arrays of the JAX package's ``replay_log``.
* Checkpoints cross both ways (the JAX package's ``save_state`` -> the
  port's ``load_state``, and the reverse) and resume an identical solve;
  the ``torch.distributed.checkpoint`` pair round-trips, ``async_save``
  included.
* ``trace_scope``, ``debug_mode`` / ``checked`` / ``assert_all_finite`` /
  ``leak_check`` case by case as in ``tests/test_utils.py`` and
  ``tests/test_debug.py``; ``count_ops`` / ``op_cost`` on known functions.
"""

import gc
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cartpole_tpu as ct  # noqa: E402
from cartpole_tpu import utils as ref_utils  # noqa: E402
import cartpole_tpu_torch as pt  # noqa: E402
from cartpole_tpu_torch import utils  # noqa: E402
from cartpole_tpu_torch.convert import mpc_state_from_numpy  # noqa: E402
from cartpole_tpu_torch.utils import roofline  # noqa: E402
from cartpole_tpu_torch.utils.debug import (  # noqa: E402
    DebugCheckError, assert_all_finite, checked, debug_mode, leak_check)

KW = dict(window_length=10, state_spacing=2, max_iterations=4)
X0 = np.array([0.1, math.pi / 2 + 0.3, -0.2, 0.5])


@pytest.fixture(scope="module")
def ref():
    """The JAX package's mpc, its jitted step, and two solves: cold from
    X0 and warm after it."""
    mpc = ct.make_mpc(ct.OptimizationParams(**KW))
    dp = ct.default_single_params(jnp.float64)
    step = jax.jit(lambda s, x: mpc.step(s, x, dp))
    out1, st1 = step(mpc.init_state(jnp.float64), jnp.asarray(X0))
    out2, st2 = step(st1, jnp.asarray(X0))
    return mpc, step, (out1, st1), (out2, st2)


@pytest.fixture(scope="module")
def port():
    mpc = pt.make_mpc(pt.OptimizationParams(**KW))
    dp = pt.default_single_params(torch.float64, device="cpu")

    def step(s, x=X0):
        return mpc.step(s, torch.as_tensor(x), dp)

    return mpc, step


def _close(a, b, path=""):
    """JSON documents equal in keys and nulls, numbers within 1e-10."""
    assert type(a) is type(b) or {type(a), type(b)} <= {int, float}, path
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}/{i}")
    elif isinstance(a, float):
        assert abs(a - b) <= 1e-10 * max(1.0, abs(b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_solve_log_entry_matches_reference(ref, port):
    _, _, (out_ref, _), _ = ref
    _, step = port
    mpc_p, _ = port
    out, _ = step(mpc_p.init_state(torch.float64, "cpu"))
    entry = utils.solve_log_entry(out)
    assert set(entry) == {"initial_state", "previous_solution",
                          "solver_outputs", "u", "predicted_states"}
    assert set(entry["initial_state"]) == {"b_x", "th_1", "th_1_dot",
                                           "b_x_dot"}
    _close(entry, ref_utils.solve_log_entry(out_ref))
    json.loads(json.dumps(entry))
    summary = utils.solver_summary(out.solver)
    assert summary.splitlines()[0] == ref_utils.solver_summary(
        out_ref.solver).splitlines()[0]
    assert "iter  0" in summary


def test_non_finite_values_serialize_as_null(port):
    mpc, step = port
    out, _ = step(mpc.init_state(torch.float64, "cpu"))
    u = out.u.clone()
    u[0] = float("nan")
    bad = out._replace(u=u, solver=out.solver._replace(
        cost=torch.tensor(float("nan")),
        first_order_norm=torch.tensor(float("inf"))))
    text = json.dumps(utils.solve_log_entry(bad))
    assert "NaN" not in text and "Infinity" not in text
    entry = json.loads(text)
    assert entry["solver_outputs"]["cost"] is None
    assert entry["u"][0] is None and entry["u"][1] is not None


def test_solve_log_ring_buffer_and_batched_extend(port, tmp_path):
    mpc, step = port
    out, _ = step(mpc.init_state(torch.float64, "cpu"))
    log = utils.SolveLog(capacity=3)
    for _ in range(5):
        log.append(out)
    assert len(log) == 3
    batched = torch.utils._pytree.tree_map(
        lambda v: torch.stack([v, v]), out)
    log = utils.SolveLog()
    log.extend_batched(batched)
    path = tmp_path / "log.json"
    log.save(str(path))
    assert json.loads(path.read_text()) == [utils.solve_log_entry(out)] * 2


def test_replay_reads_a_log_of_the_reference(ref, tmp_path):
    _, _, (out1, _), (out2, _) = ref
    log = ref_utils.SolveLog()
    log.append(out1)
    log.append(out2)
    path = str(tmp_path / "log.json")
    log.save(path)
    want = ref_utils.replay_log(ref_utils.load_log(path))
    got = utils.replay_log(utils.load_log(path))
    for name in ("states", "controls", "termination_states",
                 "predicted_states"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), name)


def test_checkpoint_from_reference_resumes_identically(ref, port, tmp_path):
    _, _, (_, st_ref), _ = ref
    mpc, step = port
    path = str(tmp_path / "ref_state")  # no .npz: both append it
    ref_utils.save_state(path, st_ref)
    restored = utils.load_state(path, mpc.init_state(torch.float64, "cpu"))
    direct = mpc_state_from_numpy(np.asarray(st_ref.previous_solution),
                                  np.asarray(st_ref.warm), device="cpu")
    assert torch.equal(restored.previous_solution, direct.previous_solution)
    assert restored.warm.dtype == torch.bool and bool(restored.warm)
    assert torch.equal(step(restored)[0].u, step(direct)[0].u)


def test_checkpoint_to_reference_resumes_identically(ref, port, tmp_path):
    mpc_ref, step_ref, _, _ = ref
    mpc, step = port
    _, st = step(mpc.init_state(torch.float64, "cpu"))
    path = str(tmp_path / "state.npz")
    utils.save_state(path, st)
    restored = ref_utils.load_state(path, mpc_ref.init_state(jnp.float64))
    direct = type(restored)(jnp.asarray(st.previous_solution.numpy()),
                            jnp.asarray(st.warm.numpy()))
    np.testing.assert_array_equal(np.asarray(step_ref(restored, X0)[0].u),
                                  np.asarray(step_ref(direct, X0)[0].u))
    with pytest.raises(KeyError, match="missing leaf"):
        utils.load_state(path, {"only": torch.zeros(3)})


def test_checkpoint_trees(tmp_path):
    tree = {"a": torch.arange(6.0), "b": (np.ones((2, 3)), None),
            "p": pt.default_single_params(torch.float64, device="cpu")}
    path = str(tmp_path / "tree")
    utils.save_state(path, tree)
    with np.load(path + ".npz") as data:
        assert sorted(data.keys()) == sorted(
            ["a", "b/0"] + [f"p/{k}" for k in tree["p"].as_dict()])
    back = utils.load_state(path, tree)
    assert torch.equal(back["a"], tree["a"]) and back["b"][1] is None
    np.testing.assert_array_equal(back["b"][0], tree["b"][0])
    assert back["p"] == tree["p"]


@pytest.mark.parametrize("async_save", [False, True])
def test_dcp_round_trip_resumes_identically(port, tmp_path, async_save):
    mpc, step = port
    _, st = step(mpc.init_state(torch.float64, "cpu"))
    path = str(tmp_path / "dcp")
    pending = utils.save_state_dcp(path, st, async_save=async_save)
    if async_save:
        pending.result()
    else:
        assert pending is None
    restored = utils.load_state_dcp(path, mpc.init_state(torch.float64,
                                                         "cpu"))
    assert torch.equal(restored.previous_solution, st.previous_solution)
    assert bool(restored.warm)
    assert torch.equal(step(restored)[0].u, step(st)[0].u)


def test_trace_scope_records_chrome_event():
    before = utils.is_tracing_enabled()
    utils.set_tracing_enabled(True)
    try:
        utils.TraceCollector.get_instance().clear()
        with utils.trace_scope("solve", batch=4):
            pass
        (ev,) = json.loads(utils.get_trace_json())["traceEvents"]
        assert ev["name"] == "solve" and ev["ph"] == "X"
        assert ev["args"] == {"batch": 4, "id": ev["args"]["id"],
                              "parent": None, "call": None}
        assert "ts" in ev and "dur" in ev
    finally:
        utils.set_tracing_enabled(before)


def test_trace_scope_ids_parents_and_calls():
    """Each span names its parent, the innermost span open around it, and
    its call, the ``call=True`` span it runs in; a span's own entries join
    its args; outside a CUDA-graph capture no device mark is made."""
    from cartpole_tpu_torch.utils.tracing import capture_marks

    before = utils.is_tracing_enabled()
    utils.set_tracing_enabled(True)
    try:
        utils.TraceCollector.get_instance().clear()
        with utils.trace_scope("outer"):
            with utils.trace_scope("call", call=True, B=3) as span:
                with capture_marks() as marks:
                    with utils.trace_scope("inner"):
                        pass
                span["pool_bytes"] = 7
        events = json.loads(utils.get_trace_json())["traceEvents"]
    finally:
        utils.set_tracing_enabled(before)
    args = {e["name"]: e["args"] for e in events}
    assert [e["name"] for e in events] == ["inner", "call", "outer"]
    assert args["outer"]["parent"] is None and args["outer"]["call"] is None
    assert args["call"]["parent"] == args["outer"]["id"]
    assert args["call"]["call"] == args["call"]["id"]
    assert args["call"]["B"] == 3 and args["call"]["pool_bytes"] == 7
    assert args["inner"]["parent"] == args["call"]["id"]
    assert args["inner"]["call"] == args["call"]["id"]
    assert len({a["id"] for a in args.values()}) == 3
    assert marks == []


def test_spans_join_the_profiler_clock(tmp_path):
    """A span's times, laid over a ``profiler_trace`` by ``join_traces``,
    bracket the ``record_function`` of the same name in the profile."""
    before = utils.is_tracing_enabled()
    utils.set_tracing_enabled(True)
    try:
        utils.TraceCollector.get_instance().clear()
        with utils.profiler_trace(str(tmp_path)):
            with utils.trace_scope("joined"):
                torch.ones(1000).cumsum(0)
        spans = json.loads(utils.get_trace_json())
    finally:
        utils.set_tracing_enabled(before)
    profile = json.loads((tmp_path / "trace.json").read_text())
    joined = utils.join_traces(profile, spans)
    (mine,) = [e for e in joined["traceEvents"]
               if e["name"] == "joined" and e.get("pid") == "spans"]
    (theirs,) = [e for e in profile["traceEvents"]
                 if e["name"] == "joined" and e.get("ph") == "X"]
    slack = 20.0  # us, for the profiler's conversion of its clock
    assert theirs["ts"] >= mine["ts"] - slack
    assert (theirs["ts"] + theirs["dur"]
            <= mine["ts"] + mine["dur"] + slack)


def test_trace_scope_disabled_is_noop():
    before = utils.is_tracing_enabled()
    utils.set_tracing_enabled(False)
    try:
        utils.TraceCollector.get_instance().clear()
        with utils.trace_scope("ignored"):
            pass
        assert utils.get_trace_json() == ""
        assert json.loads(utils.TraceCollector.get_instance()
                          .get_trace_json())["traceEvents"] == []
    finally:
        utils.set_tracing_enabled(before)


def test_profiler_trace_holds_the_span(tmp_path):
    before = utils.is_tracing_enabled()
    utils.set_tracing_enabled(True)
    try:
        with utils.profiler_trace(str(tmp_path)):
            with utils.trace_scope("span_in_profile"):
                torch.ones(3).sum()
    finally:
        utils.set_tracing_enabled(before)
    text = (tmp_path / "trace.json").read_text()
    assert "span_in_profile" in text


class TestDebugMode:
    def test_nan_raises_inside_scope(self):
        with debug_mode():
            with pytest.raises(FloatingPointError, match="NaN"):
                torch.log(torch.tensor(-1.0))

    def test_restored_after_scope(self):
        with debug_mode():
            assert torch.is_anomaly_enabled()
        assert not torch.is_anomaly_enabled()
        assert torch.isnan(torch.log(torch.tensor(-1.0)))

    def test_restored_even_on_exception(self):
        with pytest.raises(RuntimeError):
            with debug_mode():
                raise RuntimeError("boom")
        assert not torch.is_anomaly_enabled()
        assert torch.isinf(torch.tensor(1.0) / 0.0)

    def test_infs_optional(self):
        with debug_mode(infs=False):
            assert torch.isinf(torch.tensor(1.0) / 0.0)
        with debug_mode():
            with pytest.raises(FloatingPointError, match="Inf"):
                torch.tensor(1.0) / 0.0


class TestChecked:
    def test_catches_nan_inside_loop(self):
        def f(x):
            for _ in range(3):
                x = torch.sqrt(x - 2.0)
            return {"state": (torch.ones(2), x)}

        with pytest.raises(DebugCheckError, match=r"\['state'\]\[1\]"):
            checked(f)(torch.tensor(1.0))

    def test_passes_through_clean_results(self):
        f = checked(lambda x: 2.0 * x + 1.0)
        assert float(f(torch.tensor(3.0))) == 7.0

    def test_solver_step_clean_under_checks(self, port):
        mpc, step = port
        out, st = checked(step)(mpc.init_state(torch.float64, "cpu"))
        assert torch.isfinite(out.u).all()


class TestAssertAllFinite:
    def test_clean_tree_passes(self):
        assert_all_finite({"a": torch.ones(3), "b": (torch.zeros(2),)})

    def test_reports_tree_path(self):
        tree = {"xs": torch.ones((2, 2)),
                "warm": {"u": torch.tensor([1.0, float("nan"),
                                            float("inf")])}}
        with pytest.raises(DebugCheckError) as exc:
            assert_all_finite(tree, name="state")
        msg = str(exc.value)
        assert "state" in msg and "warm" in msg and "u" in msg
        assert "2/3" in msg

    def test_integer_leaves_ignored(self):
        assert_all_finite({"counts": torch.arange(5)})


class TestLeakCheck:
    def test_counts_live_tensors(self):
        gc.collect()
        base = leak_check(device="cpu")
        keep = [torch.zeros((17, 3), dtype=torch.float64) + i
                for i in range(4)]
        report = leak_check(baseline=base, device="cpu")
        assert report["by_shape"].get("float64[17, 3]", 0) >= 4
        del keep
        gc.collect()
        after = leak_check(baseline=base, device="cpu")
        assert after["by_shape"].get("float64[17, 3]", 0) <= 0
        assert after["nbytes"] < report["nbytes"]

    def test_dict_baseline_subtracts_nbytes_and_shapes(self):
        keep = [torch.zeros((23, 5)) + i for i in range(3)]
        base = leak_check(device="cpu")
        clean = leak_check(baseline=base, device="cpu")
        assert clean["count"] == 0 and clean["nbytes"] == 0
        assert not any("[23, 5]" in k for k in clean["by_shape"])
        extra = torch.ones((23, 5))
        leaked = leak_check(baseline=base, device="cpu")
        assert leaked["count"] == 1
        assert leaked["nbytes"] == extra.numel() * extra.element_size()
        assert any("[23, 5]" in k for k in leaked["by_shape"])
        del keep, extra


def test_count_ops_and_roofline():
    a, b = torch.ones(3, 4), torch.ones(4, 5)
    assert roofline.count_ops(lambda: a * a + a) == 24
    assert roofline.count_ops(lambda: a @ b) == 2 * 3 * 4 * 5
    assert roofline.count_ops(lambda: a.sum()) == 12
    cost = roofline.op_cost(torch.mul, a, a)
    assert cost == {"flops": 12.0, "bytes accessed": 3 * 12 * 4.0}
    ms, by = roofline.bound(3.35e9, 1.0)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = roofline.bound(1.0, 67e9)
    assert by == "operations" and ms == pytest.approx(1.0)
    row = roofline.roofline_row("mul", cost, 1e-3)
    assert row["bound"] == "memory" and row["measured_ms"] == 1.0


def test_params_json_round_trip():
    p = pt.SingleCartPoleParams(m_b=1.3, k_s=77.0)
    data = json.loads(p.to_json())
    assert data == json.loads(ct.SingleCartPoleParams(m_b=1.3,
                                                      k_s=77.0).to_json())
    assert pt.SingleCartPoleParams.from_json(p.to_json()) == p
    for cls in (pt.DoubleCartPoleParams, pt.TripleCartPoleParams):
        assert cls.from_json(cls().to_json()) == cls()
    with pytest.raises(ValueError, match="unknown DoubleCartPoleParams"):
        pt.DoubleCartPoleParams.from_json('{"mb": 1.0}')
