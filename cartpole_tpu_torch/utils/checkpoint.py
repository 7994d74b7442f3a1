"""Checkpoint / resume for solver-state trees (counterpart of
``cartpole_tpu/utils/checkpoint.py``).

The reference controller's resumable state IS its warm start
(``previous_solution_`` kept across ``Step`` calls,
``optimization.hpp:83-89,107``). Here that state is an explicit tree
(``MPCState``, plant states, whole batched sweeps), so a checkpoint is a
save and load of its tensor leaves keyed by tree path:

* :func:`save_state` / :func:`load_state`: one ``.npz``, keyed as the JAX
  package keys it (a namedtuple's or dataclass's field name, a dict key, a
  sequence index, joined by ``/``; ``_root`` for a bare leaf), so a
  checkpoint written by either package loads in the other;
* :func:`save_state_dcp` / :func:`load_state_dcp`: the counterparts of the
  reference's ``save_state_orbax`` / ``load_state_orbax``, through
  ``torch.distributed.checkpoint`` (``save`` / ``async_save`` / ``load``),
  which is to torch what orbax is to JAX: each rank writes its own shard
  of a distributed sweep, and ``async_save`` drains to disk while the loop
  goes on.
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Any

import numpy as np
import torch
import torch.utils._pytree as pytree

__all__ = [
    "save_state",
    "load_state",
    "save_state_dcp",
    "load_state_dcp",
]

_SEP = "/"


def _key(path) -> str:
    """The JAX package's key of a leaf: field names, dict keys and
    sequence indices joined by ``/``; ``_root`` for a bare leaf."""
    parts = []
    for k in path:
        if isinstance(k, pytree.GetAttrKey):
            parts.append(k.name)
        elif isinstance(k, pytree.MappingKey):
            parts.append(str(k.key))
        elif isinstance(k, pytree.SequenceKey):
            parts.append(str(k.idx))
        else:
            parts.append(str(k))
    return _SEP.join(parts) if parts else "_root"


def _leaves(tree: Any):
    """``[(key, leaf)]`` of the tree's leaves (``None`` holds none) and its
    spec."""
    flat, spec = pytree.tree_flatten_with_path(tree)
    return [(_key(p), leaf) for p, leaf in flat], spec


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _like(value: np.ndarray, ref):
    """``value`` in the dtype and on the device of ``ref``: a tensor for a
    tensor, a numpy array otherwise."""
    if isinstance(ref, torch.Tensor):
        return torch.as_tensor(value).to(dtype=ref.dtype, device=ref.device)
    return value.astype(np.asarray(ref).dtype)


def _npz_path(path: str) -> str:
    # np.savez silently appends .npz to extensionless paths; normalize on
    # both save and load so the round trip works for any path string.
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: str, tree: Any) -> None:
    """Persist a tree of tensors (or arrays) to ``.npz``, keyed by tree
    path. Device tensors are copied to the host."""
    payload = {}
    for key, leaf in _leaves(tree)[0]:
        if leaf is None:
            continue
        if key in payload:
            raise ValueError(f"duplicate checkpoint key {key!r}")
        payload[key] = _to_numpy(leaf)
    np.savez(_npz_path(path), **payload)


def load_state(path: str, like: Any) -> Any:
    """Restore a tree saved by :func:`save_state` (by either package) into
    the structure of ``like``; each leaf takes the dtype and device of
    ``like``'s leaf."""
    leaves, spec = _leaves(like)
    out = []
    with np.load(_npz_path(path)) as data:
        for key, ref in leaves:
            if ref is None:
                out.append(None)
                continue
            if key not in data:
                raise KeyError(f"checkpoint {path} missing leaf {key!r}; "
                               f"has {sorted(data.keys())}")
            value = data[key]
            shape = tuple(np.shape(ref))
            if value.shape != shape:
                raise ValueError(
                    f"leaf {key!r} shape {value.shape} != expected {shape}")
            out.append(_like(value, ref))
    return pytree.tree_unflatten(out, spec)


def _state_dict(tree: Any) -> dict:
    return {k: torch.as_tensor(leaf) for k, leaf in _leaves(tree)[0]
            if leaf is not None}


@contextlib.contextmanager
def _single_process_ok():
    """Silence the library's note that it saves or loads in a single
    process: without a process group that is what this module asks for."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is "
                                "disabled, unavailable or uninitialized")
        yield


def save_state_dcp(path: str, tree: Any, *, async_save: bool = False):
    """Persist a tree checkpoint with ``torch.distributed.checkpoint``.

    ``path`` is a directory. Under a process group every rank writes its
    own leaves; a single process writes alone. With ``async_save=True`` the
    write happens in a background thread and the returned future MUST be
    waited on (``.result()``) before the process exits; otherwise this
    returns ``None`` once the checkpoint is on disk.
    """
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    no_dist = not dist.is_initialized()
    state = _state_dict(tree)
    with _single_process_ok():
        if async_save:
            return dcp.async_save(state, checkpoint_id=path, no_dist=no_dist)
        dcp.save(state, checkpoint_id=path, no_dist=no_dist)
    return None


def load_state_dcp(path: str, like: Any) -> Any:
    """Restore a tree saved by :func:`save_state_dcp` into the structure,
    dtypes and devices of ``like`` (each leaf is loaded in place into a
    copy of ``like``'s)."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    state = {k: v.clone() for k, v in _state_dict(like).items()}
    with _single_process_ok():
        dcp.load(state, checkpoint_id=os.path.abspath(path),
                 no_dist=not dist.is_initialized())
    leaves, spec = _leaves(like)
    return pytree.tree_unflatten(
        [None if ref is None else _like(_to_numpy(state[k]), ref)
         for k, ref in leaves], spec)
