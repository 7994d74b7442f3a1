"""Dynamics parameters of the cart-pole models (counterpart of
``cartpole_tpu/models/params.py``).

Every field is a tensor: 0-d for one plant shared by the batch, or ``(B,)``
for per-instance plants. Field order is the order the generated dynamics
take them in (``models/_<version>_gen.py``). Each dataclass is a pytree node
of ``torch.utils._pytree``, as a dataclass of arrays is in JAX, so
``torch.func.grad`` takes one as an argument and returns its gradient as the
same dataclass.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.utils._pytree as pytree

__all__ = [
    "SingleCartPoleParams",
    "DoubleCartPoleParams",
    "TripleCartPoleParams",
    "default_single_params",
    "default_double_params",
    "default_triple_params",
]


class _Params:
    """Field access shared by the parameter dataclasses."""

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def as_tuple(self) -> tuple:
        """Fields in the generated dynamics' argument order."""
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    def to(self, dtype=None, device=None):
        return type(self)(**{
            k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in self.as_dict().items()
        })


@dataclasses.dataclass(frozen=True)
class SingleCartPoleParams(_Params):
    """Physical parameters of the cart + single pole system."""

    m_b: Any = 1.0  #: Mass of the base / cart (kg).
    m_1: Any = 0.1  #: Point mass at the pole tip (kg).
    l_1: Any = 0.25  #: Pole length (m).
    g: Any = 9.81  #: Gravitational acceleration (m/s^2).
    mu_b: Any = 0.03  #: Coulomb friction coefficient at the base.
    v_mu_b: Any = 0.1  #: Cutoff velocity of the smoothed Coulomb model (m/s).
    c_d_1: Any = 0.13  #: Air-drag coefficient on the pole mass (rho*C_d*A).
    x_s: Any = 0.8  #: Position of the boundary bumper springs (m).
    k_s: Any = 100.0  #: Bumper spring constant (N/m).


@dataclasses.dataclass(frozen=True)
class DoubleCartPoleParams(_Params):
    """Physical parameters of the cart + two-link pole system (no friction,
    drag or springs)."""

    m_b: Any = 1.0  #: Mass of the base / cart (kg).
    m_1: Any = 0.1  #: Point mass at the first link tip (kg).
    m_2: Any = 0.1  #: Point mass at the second link tip (kg).
    l_1: Any = 0.25  #: First link length (m).
    l_2: Any = 0.25  #: Second link length (m).
    g: Any = 9.81  #: Gravitational acceleration (m/s^2).


@dataclasses.dataclass(frozen=True)
class TripleCartPoleParams(_Params):
    """Physical parameters of the cart + three-link pole chain (no
    friction, drag or springs)."""

    m_b: Any = 1.0  #: Mass of the base / cart (kg).
    m_1: Any = 0.1  #: Point mass at the first link tip (kg).
    m_2: Any = 0.1  #: Point mass at the second link tip (kg).
    m_3: Any = 0.1  #: Point mass at the third link tip (kg).
    l_1: Any = 0.25  #: First link length (m).
    l_2: Any = 0.25  #: Second link length (m).
    l_3: Any = 0.25  #: Third link length (m).
    g: Any = 9.81  #: Gravitational acceleration (m/s^2).


for _cls in (SingleCartPoleParams, DoubleCartPoleParams,
             TripleCartPoleParams):
    pytree.register_pytree_node(
        _cls, lambda p: (list(p.as_tuple()), None),
        lambda fields, _ctx, cls=_cls: cls(*fields),
        serialized_type_name=f"{__name__}.{_cls.__name__}")


def default_single_params(dtype=torch.float32, device="cuda"
                          ) -> SingleCartPoleParams:
    """The nominal system of the reference closed-loop test, as 0-d
    tensors on ``device`` (the card unless the caller asks for the CPU)."""
    return SingleCartPoleParams().to(dtype=dtype, device=device)


def default_double_params(dtype=torch.float32, device="cuda"
                          ) -> DoubleCartPoleParams:
    """The nominal double pole, as 0-d tensors on ``device``."""
    return DoubleCartPoleParams().to(dtype=dtype, device=device)


def default_triple_params(dtype=torch.float32, device="cuda"
                          ) -> TripleCartPoleParams:
    """The nominal triple pole, as 0-d tensors on ``device``."""
    return TripleCartPoleParams().to(dtype=dtype, device=device)
