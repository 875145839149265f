"""The port's checkpoint format: a directory holding one ``torch.save`` file.

A checkpoint is a variable tree (nested dicts of numpy arrays or tensors,
such as an importer's output), written by :func:`save_checkpoint` and read
back by :func:`load_checkpoint` as a tree of numpy arrays with the same
keys, dtypes and values, ready for ``TwoStagePipeline.from_jax_vars``.
The file is read with ``weights_only=True``, so loading one runs no code.

The JAX package checkpoints through orbax (its ``weights/checkpoint.py``).
Reading that format needs orbax and JAX, which the port does not import:
:func:`load_checkpoint` recognises an orbax directory and says so.  The
training-state pair (``save_train_checkpoint`` / ``load_train_checkpoint``)
comes with the port of training.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

CHECKPOINT_FILE = "variables.pt"
# files that only an orbax checkpoint directory holds
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


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


def load_checkpoint(path: str) -> Any:
    """The tree saved at ``path`` by :func:`save_checkpoint`, as numpy
    arrays.  Raises ``ValueError`` for an orbax directory (the JAX
    package's format) and for a directory without the port's file."""
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
    return _to_numpy(torch.load(file, map_location="cpu", weights_only=True))
