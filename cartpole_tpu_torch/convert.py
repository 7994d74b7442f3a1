"""Cross-over from the JAX package's values, as numpy arrays.

Both functions take plain numpy data (no jax import), so the tests can hand
the reference's inputs to the port and both packages compute the same
thing. Like every entry point of the port they put their tensors on the
card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.base import SINGLE_CARTPOLE, CartPoleModel
from .mpc.controller import MPCState

__all__ = ["params_from_numpy", "mpc_state_from_numpy"]


def params_from_numpy(d: dict, device="cuda", dtype=torch.float64,
                      model: CartPoleModel = SINGLE_CARTPOLE):
    """``model``'s params (``SingleCartPoleParams`` by default) from the
    reference's ``as_dict()`` of the same model's params converted to
    numpy: each value a scalar or a ``(B,)`` per-instance array."""
    return model.params_type(**{
        k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
        for k, v in d.items()
    })


def mpc_state_from_numpy(previous_solution, warm, device="cuda",
                         dtype=torch.float64) -> MPCState:
    """Warm-start state: a batch's (``previous_solution`` ``(B, dim)``,
    ``warm`` ``(B,)`` bool) or one instance's (``(dim,)`` and a scalar)."""
    return MPCState(
        previous_solution=torch.as_tensor(np.array(previous_solution),
                                          dtype=dtype, device=device),
        warm=torch.as_tensor(np.array(warm, bool), device=device),
    )
