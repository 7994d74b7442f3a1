"""The port's own binding of the C++ parity oracle (``cartpole_tpu_torch/
native.py``) against the JAX package's (``cartpole_tpu/native.py``), and
the port's ``lu`` closed loop against the oracle.

Both bindings build ``native/oracle.cc`` with the same compiler line, each
into its own package's build directory, so every function gives the same
bits on the same inputs. The port's ``run_closed_loop`` with
``kkt_method="lu"`` (the path the oracle pins, ``tests/test_native.py``)
stays within 1e-4 of the oracle's controls and 1e-5 of its states over 30
ticks from the hanging pole, at the oracle test's configuration (window
40, spacing 5, 10 GN iterations). At smaller windows the solves stop at
their iteration limit, and the two loops drift apart faster.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cartpole_tpu_torch")

from cartpole_tpu import DoubleCartPoleParams as RefDouble
from cartpole_tpu import OptimizationParams as RefParams
from cartpole_tpu import SingleCartPoleParams as RefSingle
from cartpole_tpu import native as ref_native
import cartpole_tpu_torch as pt
from cartpole_tpu_torch import native

DOWN = np.array([0.0, -np.pi / 2, 0.0, 0.0])
KW = dict(window_length=10, state_spacing=2, max_iterations=10,
          kkt_method="lu")


@pytest.fixture(scope="module", autouse=True)
def built():
    if not (native.is_available() and ref_native.is_available()):
        pytest.fail("g++ cannot build native/oracle.cc")


def _single():
    vals = dict(m_b=1.3, m_1=0.21, l_1=0.31, g=9.81, mu_b=0.04, v_mu_b=0.11,
                c_d_1=0.17, x_s=0.75, k_s=140.0)
    return RefSingle(**vals), pt.SingleCartPoleParams(**vals)


def test_single_functions_bit_equal():
    ref_p, p = _single()
    rng = np.random.RandomState(3)
    for _ in range(10):
        x, u, f = rng.uniform(-2, 2, 4), rng.uniform(-100, 100), \
            rng.uniform(-5, 5, 4)
        for got, want in (
                (native.oracle_dynamics(p, x, u, f[:2], f[2:]),
                 ref_native.oracle_dynamics(ref_p, x, u, f[:2], f[2:])),
                (native.oracle_dynamics(p, x, u),
                 ref_native.oracle_dynamics(ref_p, x, u)),
                (native.oracle_rk4(p, x, u, 0.01),
                 ref_native.oracle_rk4(ref_p, x, u, 0.01)),
                (native.oracle_sim_step(p, x, 0.0125, u, f[:2], f[2:]),
                 ref_native.oracle_sim_step(ref_p, x, 0.0125, u, f[:2],
                                            f[2:]))):
            np.testing.assert_array_equal(got, want)


def test_double_functions_bit_equal():
    ref_p, p = RefDouble(), pt.DoubleCartPoleParams()
    rng = np.random.RandomState(7)
    for _ in range(5):
        x, u, f = rng.uniform(-1, 1, 6), rng.uniform(-50, 50), \
            rng.uniform(-3, 3, 6)
        np.testing.assert_array_equal(
            native.oracle_double_dynamics(p, x, u, f[:2], f[2:4], f[4:]),
            ref_native.oracle_double_dynamics(ref_p, x, u, f[:2], f[2:4],
                                              f[4:]))
        np.testing.assert_array_equal(
            native.oracle_double_sim_step(p, x, 0.01, u),
            ref_native.oracle_double_sim_step(ref_p, x, 0.01, u))


def test_closed_loop_bit_equal():
    ref_p, p = _single()
    got = native.oracle_closed_loop(p, pt.OptimizationParams(**KW), DOWN, 6)
    want = ref_native.oracle_closed_loop(ref_p, RefParams(**KW), DOWN, 6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(native._opt_vec(pt.OptimizationParams()),
                                  ref_native._opt_vec(RefParams()))


def test_params_as_tensors():
    """The port's params hold 0-d tensors; the binding reads them."""
    ref_p = RefSingle()
    p = pt.default_single_params(torch.float64, device="cpu")
    x = np.array([0.1, 0.2, -0.3, 0.4])
    np.testing.assert_array_equal(native.oracle_dynamics(p, x, 3.0),
                                  ref_native.oracle_dynamics(ref_p, x, 3.0))


def test_lu_closed_loop_against_the_oracle():
    opt = pt.OptimizationParams(max_iterations=10, state_spacing=5,
                                kkt_method="lu")
    u_nat, states_nat = native.oracle_closed_loop(pt.SingleCartPoleParams(),
                                                  opt, DOWN, 30)
    res = pt.run_closed_loop(pt.make_mpc(opt), torch.as_tensor(DOWN),
                             pt.default_single_params(torch.float64,
                                                      device="cpu"), 30)
    assert np.abs(u_nat - res.controls.numpy()).max() <= 1e-4
    np.testing.assert_allclose(states_nat, res.states.numpy(), atol=1e-5)
    assert np.abs(u_nat).max() > 1.0  # the loop did steer
