"""Drop-in ``pypendulum`` compatibility layer on the card (counterpart of
``cartpole_tpu/pypendulum.py``).

The reference ships a nanobind module ``pypendulum`` built from
``wrapper/wrapper.cc:40-103`` (classes ``SingleCartPoleParams``,
``OptimizationParams``, ``SingleCartPoleState``, ``OptimizationOutputs``,
``Optimization``, ``Vector2``, ``Simulator``). This module mirrors that
surface exactly (mutable field-by-field structs, the same constructor
signatures and argument orders, the same method names), so scripts written
against the reference (e.g. ``model/scratch.py:22-77``) run unchanged on
the torch stack::

    import cartpole_tpu_torch.pypendulum as pypendulum

After that import a plain ``import pypendulum`` resolves here too, unless
another module registered that name first (``sys.modules.setdefault``: the
first shim imported keeps the name, and none overwrites another).

Device and precision: the solves and the plant run on the CUDA device in
f64 (the reference is C++ ``double``) by default; :func:`configure` picks
another device or dtype (e.g. ``configure(device="cpu")`` or
``configure(dtype=torch.float32)``) for objects made after the call. The
solver runs the ``lu`` reference-parity KKT path by default (see
:class:`Optimization`).

Semantics preserved from the nanobind wrapper:

* ``Optimization(params)`` snapshots the params at construction: later
  mutation of the params object does not affect an existing instance
  (``optimization.cc:303-330`` builds the solver on first use).
* ``Optimization.step(state, dynamics_params, b_x_set_point)`` carries the
  warm start internally across calls (``optimization.hpp:107``).
* ``set_previous_solution(guess)`` seeds the next solve
  (``optimization.hpp:86-89``); ``reset()`` discards it
  (``optimization.hpp:83``, exposed by the WASM binding).
* ``Simulator`` starts at the hanging state ``{0, -pi/2, 0, 0}``
  (``simulator.hpp:28``) and integrates with 1 ms substeps.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np
import torch

from .models import params as _params
from .mpc import simulator as _simulator
from .mpc.config import OptimizationParams as _FrozenOptimizationParams
from .mpc.controller import MPC as _MPC
from .utils._host import host as _host
from .utils.logging import solver_summary as _solver_summary

__all__ = [
    "SingleCartPoleParams",
    "SingleCartPoleState",
    "OptimizationParams",
    "OptimizationOutputs",
    "Optimization",
    "Vector2",
    "Simulator",
    "configure",
]

_DYNAMICS_FIELDS = (
    "m_b", "m_1", "l_1", "g", "mu_b", "v_mu_b", "c_d_1", "x_s", "k_s",
)

#: The reference OptimizationParams surface (``wrapper.cc:57-72``), with the
#: defaults of ``optimization.hpp:12-53``.
_OPT_FIELDS = (
    "control_dt", "window_length", "state_spacing", "max_iterations",
    "relative_exit_tol", "absolute_first_derivative_tol",
    "equality_penalty_initial", "u_guess_sinusoid_amplitude",
    "u_cost_weight", "u_derivative_cost_weight",
    "b_x_final_cost_weight", "th_final_cost_weight",
    "b_x_dot_final_cost_weight", "th_dot_final_cost_weight",
)

#: Where and in what precision objects made from now on compute.
_config = {"device": "cuda", "dtype": torch.float64}


def configure(device=None, dtype=None) -> None:
    """Set the device (default ``"cuda"``) and/or dtype (default
    ``torch.float64``) of the ``Optimization`` and ``Simulator`` objects
    made after the call."""
    if device is not None:
        _config["device"] = device
    if dtype is not None:
        _config["dtype"] = dtype


class SingleCartPoleParams:
    """Mutable mirror of ``pendulum::SingleCartPoleParams``
    (``structs.hpp:8-41``; binding ``wrapper.cc:41-54``). Constructor takes
    the 9 parameters positionally in the reference order."""

    def __init__(self, m_b=1.0, m_1=0.1, l_1=0.25, g=9.81, mu_b=0.03,
                 v_mu_b=0.1, c_d_1=0.13, x_s=0.8, k_s=100.0):
        (self.m_b, self.m_1, self.l_1, self.g, self.mu_b, self.v_mu_b,
         self.c_d_1, self.x_s, self.k_s) = (
            m_b, m_1, l_1, g, mu_b, v_mu_b, c_d_1, x_s, k_s)

    def _frozen(self, dtype, device):
        return _params.SingleCartPoleParams(**{
            k: float(getattr(self, k)) for k in _DYNAMICS_FIELDS
        }).to(dtype, device)

    def __repr__(self):
        inner = ", ".join(
            f"{k}={getattr(self, k)!r}" for k in _DYNAMICS_FIELDS)
        return f"SingleCartPoleParams({inner})"


class SingleCartPoleState:
    """Mutable mirror of ``pendulum::SingleCartPoleState``
    (``structs.hpp:44-64``): fields/ctor order ``(b_x, th_1, b_x_dot,
    th_1_dot)``."""

    def __init__(self, b_x=0.0, th_1=0.0, b_x_dot=0.0, th_1_dot=0.0):
        self.b_x, self.th_1 = float(b_x), float(th_1)
        self.b_x_dot, self.th_1_dot = float(b_x_dot), float(th_1_dot)

    def to_vector(self):
        """``ToVector()`` analog: ndarray ``[b_x, th_1, b_x_dot, th_1_dot]``."""
        return np.array([self.b_x, self.th_1, self.b_x_dot, self.th_1_dot])

    @classmethod
    def _from_array(cls, x):
        x = np.asarray(x, dtype=float)
        return cls(x[0], x[1], x[2], x[3])

    def __repr__(self):
        return (f"SingleCartPoleState(b_x={self.b_x!r}, th_1={self.th_1!r}, "
                f"b_x_dot={self.b_x_dot!r}, th_1_dot={self.th_1_dot!r})")


class OptimizationParams:
    """Mutable mirror of ``pendulum::OptimizationParams``
    (``optimization.hpp:12-53``; binding ``wrapper.cc:57-72``)."""

    def __init__(self, **kwargs):
        defaults = _FrozenOptimizationParams()
        for k in _OPT_FIELDS:
            setattr(self, k, getattr(defaults, k))
        for k, v in kwargs.items():
            if k not in _OPT_FIELDS:
                raise TypeError(f"unknown OptimizationParams field: {k}")
            setattr(self, k, v)

    def _frozen(self) -> _FrozenOptimizationParams:
        return _FrozenOptimizationParams(**{
            k: (int(getattr(self, k))
                if k in ("window_length", "state_spacing", "max_iterations")
                else float(getattr(self, k)))
            for k in _OPT_FIELDS
        })

    def __repr__(self):
        inner = ", ".join(f"{k}={getattr(self, k)!r}" for k in _OPT_FIELDS)
        return f"OptimizationParams({inner})"


class OptimizationOutputs:
    """Mirror of ``pendulum::OptimizationOutputs`` (``optimization.hpp:55-70``;
    binding ``wrapper.cc:81-85``). ``u`` is a list of floats,
    ``predicted_states`` a list of :class:`SingleCartPoleState`."""

    def __init__(self, outputs):
        self._outputs = outputs  # the underlying MPCOutputs
        self.initial_state = SingleCartPoleState._from_array(
            _host(outputs.initial_state))
        self.previous_solution = [
            float(v) for v in _host(outputs.previous_solution)]
        self.u = [float(v) for v in _host(outputs.u)]
        self.predicted_states = [
            SingleCartPoleState._from_array(row)
            for row in _host(outputs.predicted_states)
        ]

    def solver_summary(self) -> str:
        """``NLSSolverOutputs.ToString()`` analog (``wrapper.cc:82-83``)."""
        return _solver_summary(self._outputs.solver)


class Optimization:
    """Mirror of ``pendulum::Optimization`` (``optimization.hpp:73-108``;
    binding ``wrapper.cc:87-90``): a stateful object carrying the warm
    start across ``step`` calls.

    The shim defaults to the ``lu`` KKT path, the reference-parity
    factorization. The package-wide default is the ``condensed`` fast path,
    whose (exact) re-factorization shifts iterates by ~1e-4/step, which
    closed-loop chaos amplifies; pass ``kkt_method="condensed"`` to opt in
    when throughput matters more than trajectory identity."""

    def __init__(self, params: OptimizationParams, kkt_method: str = "lu"):
        self._dtype, self._device = _config["dtype"], _config["device"]
        self._mpc = _MPC(params._frozen().replace(kkt_method=kkt_method))
        self._state = self._mpc.init_state(self._dtype, self._device)

    def step(self, current_state: SingleCartPoleState,
             dynamics_params: SingleCartPoleParams,
             b_x_set_point: float = 0.0) -> OptimizationOutputs:
        x0 = torch.as_tensor(current_state.to_vector(), dtype=self._dtype,
                             device=self._device)
        dp = dynamics_params._frozen(self._dtype, self._device)
        outputs, self._state = self._mpc.step(
            self._state, x0, dp, float(b_x_set_point))
        return OptimizationOutputs(outputs)

    def reset(self) -> None:
        """Discard the warm start (``optimization.hpp:83``)."""
        self._state = self._mpc.reset(self._state)

    def set_previous_solution(self, guess: Sequence[float]) -> None:
        guess = torch.as_tensor(np.asarray(guess, dtype=float),
                                dtype=self._dtype, device=self._device)
        if tuple(guess.shape) != (self._mpc.spec.dim,):
            raise ValueError(
                f"guess must have {self._mpc.spec.dim} entries, "
                f"got {tuple(guess.shape)}")
        self._state = self._mpc.set_previous_solution(self._state, guess)


class Vector2:
    """Mirror of ``pendulum::Vector2`` (``structs.hpp:67-70``)."""

    def __init__(self, x=0.0, y=0.0):
        self.x, self.y = float(x), float(y)

    def __repr__(self):
        return f"Vector2({self.x!r}, {self.y!r})"


class Simulator:
    """Mirror of ``pendulum::Simulator`` (``simulator.hpp:10-29``; binding
    ``wrapper.cc:94-97``): 1 kHz substeps, angle wrap, external forces."""

    def __init__(self):
        self._sim = _simulator.Simulator(dtype=_config["dtype"],
                                         device=_config["device"])

    def step(self, params: SingleCartPoleParams, dt: float, u: float,
             f_base: Optional[Vector2] = None,
             f_mass: Optional[Vector2] = None) -> None:
        x = self._sim.get_state()

        def force(v):
            return torch.tensor([v.x, v.y] if v is not None else [0.0, 0.0],
                                dtype=x.dtype, device=x.device)

        self._sim.step(params._frozen(x.dtype, x.device), float(dt),
                       float(u), f_base=force(f_base), f_mass=force(f_mass))

    def get_state(self) -> SingleCartPoleState:
        return SingleCartPoleState._from_array(_host(self._sim.get_state()))

    def set_state(self, state: SingleCartPoleState) -> None:
        """``SetState`` analog (``simulator.hpp:24``)."""
        self._sim.set_state(state.to_vector())


# ``import pypendulum`` resolves here once this module has been imported,
# unless another shim registered the name first: setdefault never
# overwrites it.
sys.modules.setdefault("pypendulum", sys.modules[__name__])
