"""The port's checkpoint format: a directory holding one ``torch.save`` file.

A checkpoint is a variable tree (nested dicts of numpy arrays or tensors,
such as an importer's output), written by :func:`save_checkpoint` and read
back by :func:`load_checkpoint` as a tree of numpy arrays with the same
keys, dtypes and values, ready for ``TwoStagePipeline.from_jax_vars``.
The file is read with ``weights_only=True``, so loading one runs no code.

The JAX package checkpoints through orbax (its ``weights/checkpoint.py``).
Reading that format needs orbax and JAX, which the port does not import:
:func:`load_checkpoint` and :func:`load_train_checkpoint` recognise an
orbax directory and say so.

A training checkpoint (:func:`save_train_checkpoint`) is one more such
directory, holding the whole training state (the model's ``state_dict``,
the optimizer state, the step, the EMA) and the loop's meta (epoch cursor,
best score), swapped in as the JAX package swaps its resume point: written
to ``path.new``, then ``path`` -> ``path.old``, ``path.new`` -> ``path``,
``path.old`` removed, so a crash at any moment leaves a whole resume point
(:func:`load_train_checkpoint` promotes a ``path.old`` left without
``path``).

Across the ranks of a ``torch.distributed`` group (data-parallel training,
``parallel/mesh.py``) the JAX package's multi-host contract holds: the
state is replicated, so rank 0 alone writes and renames, on a filesystem
every rank shares, and every rank waits at a barrier before going on; the
``.old`` promotion happens on rank 0 under the barrier, and then every rank
loads the result.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

CHECKPOINT_FILE = "variables.pt"
# files that only an orbax checkpoint directory holds
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


def _is_writer() -> bool:
    """True on rank 0 of a group, and in a process outside any group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _sync() -> None:
    """A barrier of every rank; nothing on one process."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _to_tensors(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {str(k): _to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return torch.from_numpy(np.array(tree))


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.numpy()


def save_checkpoint(path: str, tree: Any) -> None:
    """Write ``tree`` (nested dicts of numpy arrays or tensors) to the
    directory ``path``, replacing the file of an earlier save."""
    os.makedirs(path, exist_ok=True)
    dst = os.path.join(path, CHECKPOINT_FILE)
    tmp = dst + ".tmp"
    torch.save(_to_tensors(tree), tmp)
    os.replace(tmp, dst)


def _checkpoint_file(path: str) -> str:
    """``path``'s checkpoint file; raises ``ValueError`` for an orbax
    directory (the JAX package's format) and for a directory without the
    port's file."""
    if any(os.path.exists(os.path.join(path, m)) for m in _ORBAX_MARKERS):
        raise ValueError(
            f"{path} is an orbax checkpoint (the JAX package's format); "
            "reading it needs orbax and JAX, which the PyTorch port does "
            "not use: load it with the JAX package and save it again with "
            "litepi_tpu_torch.weights.checkpoint.save_checkpoint"
        )
    file = os.path.join(path, CHECKPOINT_FILE)
    if not os.path.isfile(file):
        raise ValueError(f"{path} holds no {CHECKPOINT_FILE}: not a checkpoint of the port")
    return file


def load_checkpoint(path: str) -> Any:
    """The tree saved at ``path`` by :func:`save_checkpoint`, as numpy
    arrays.  Raises ``ValueError`` for an orbax directory (the JAX
    package's format) and for a directory without the port's file."""
    file = _checkpoint_file(path)
    return _to_numpy(torch.load(file, map_location="cpu", weights_only=True))


def _host(tree: Any) -> Any:
    """``tree`` (dicts, lists, tensors, numbers) with every tensor detached
    on the CPU."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


def _place(tree: Any, like: Any) -> Any:
    """``tree`` with each tensor moved to the device and dtype of the
    tensor in the same place of ``like``."""
    if isinstance(like, dict):
        return {k: _place(tree[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if len(tree) != len(like):
            raise ValueError("training checkpoint does not match the state's topology")
        return [_place(t, v) for t, v in zip(tree, like)]
    if isinstance(like, torch.Tensor):
        if tuple(tree.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {tuple(tree.shape)} != state's {tuple(like.shape)}")
        return tree.to(device=like.device, dtype=like.dtype)
    return tree


def save_train_checkpoint(path: str, state: Any, meta: Dict[str, Any]) -> None:
    """Persist a whole training state (a ``train/detector.py`` or
    ``train/classifier.py`` state: the model's ``state_dict``, optimizer
    state, step, EMA) and ``meta`` (the loop's scalars: epoch cursor, best
    score) to the directory ``path``, for exact resumption.  The previous
    resume point survives until the new one is whole (see the module
    docstring)."""
    path = os.path.abspath(path)
    new, old = path + ".new", path + ".old"
    if _is_writer():
        for stale in (new, old):
            if os.path.isdir(stale):
                shutil.rmtree(stale)
        payload = {
            "model": _host(state.model.state_dict()),
            "opt_state": _host(state.opt_state),
            "step": int(state.step),
            "ema_params": _host(getattr(state, "ema_params", None)),
            "meta": {k: (v.item() if hasattr(v, "item") else v) for k, v in meta.items()},
        }
        os.makedirs(new)
        torch.save(payload, os.path.join(new, CHECKPOINT_FILE))
        if os.path.isdir(path):
            os.rename(path, old)
        os.rename(new, path)
        if os.path.isdir(old):
            shutil.rmtree(old)
    _sync()


def load_train_checkpoint(
    path: str, like_state: Any, meta_template: Optional[Dict[str, Any]] = None
) -> Tuple[Any, Dict[str, Any]]:
    """Restore ``(state, meta)`` saved by :func:`save_train_checkpoint`
    into ``like_state`` (a fresh state of the same model and optimizer,
    whose tensors give each leaf's device and dtype; it is returned,
    filled).  A ``path.old`` left without ``path`` (a crash between the
    swap's renames) is promoted first.  ``meta_template`` gives the meta
    keys to return (all saved keys without it).  Raises ``ValueError`` for
    an orbax directory.  Across ranks: rank 0 promotes, every rank waits at
    a barrier, then every rank loads."""
    path = os.path.abspath(path)
    if _is_writer() and not os.path.isdir(path) and os.path.isdir(path + ".old"):
        os.rename(path + ".old", path)
    _sync()
    payload = torch.load(_checkpoint_file(path), map_location="cpu", weights_only=True)
    if not {"model", "opt_state", "step", "meta"} <= set(payload):
        raise ValueError(f"{path} holds variables, not a training checkpoint of the port")
    model = like_state.model
    model.load_state_dict(_place(payload["model"], model.state_dict()))
    like_state.opt_state = _place(payload["opt_state"], like_state.opt_state)
    like_state.step = int(payload["step"])
    if getattr(like_state, "ema_params", None) is not None:
        like_state.ema_params = _place(payload["ema_params"], like_state.ema_params)
    meta = payload["meta"]
    if meta_template is not None:
        meta = {k: meta[k] for k in meta_template}
    return like_state, meta
