"""Host copies of tensors, for the modules that write or draw them."""

from __future__ import annotations

import numpy as np


def host(a) -> np.ndarray:
    """``a`` as a numpy array: a tensor (on any device) is detached and
    copied to the host; anything else goes through ``np.asarray``."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)
