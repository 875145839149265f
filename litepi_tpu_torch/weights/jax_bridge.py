"""JAX variables -> the port's ``state_dict``s.

The input is a Flax variable tree given as nested dicts of numpy arrays,
``{"params": ..., "batch_stats": ...}`` (folded trees carry no
``batch_stats``).  The port's modules use the Flax names, so each leaf maps
mechanically:

* ``params/<path>/kernel``: a conv kernel HWIO -> OIHW ``<path>.weight``
  (depthwise ``(kh, kw, 1, C)`` -> ``(C, 1, kh, kw)``); a Dense kernel
  ``(in, out)`` -> its transpose;
* ``params/<path>/bias`` -> ``<path>.bias``; BatchNorm ``scale`` ->
  ``<path>.weight``;
* ``batch_stats/<path>/mean``, ``var`` -> ``<path>.running_mean``,
  ``running_var`` (plus a zero ``num_batches_tracked``).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Dict[str, Any], path: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _kernel(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4:  # HWIO -> OIHW
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 2:  # Dense (in, out) -> Linear (out, in)
        return arr.T
    raise ValueError(f"unexpected kernel rank {arr.ndim}")


def jax_to_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a Flax variable tree onto the port's ``state_dict`` keys."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(variables["params"]):
        arr = np.asarray(leaf, dtype=np.float32)
        if path[-1] not in _PARAM_LEAVES:
            raise ValueError(f"unexpected parameter {'/'.join(path)}")
        if path[-1] == "kernel":
            arr = _kernel(arr)
        key = ".".join(path[:-1] + (_PARAM_LEAVES[path[-1]],))
        out[key] = torch.from_numpy(arr.copy())
    for path, leaf in _leaves(variables.get("batch_stats") or {}):
        if path[-1] not in _STAT_LEAVES:
            raise ValueError(f"unexpected statistic {'/'.join(path)}")
        arr = np.asarray(leaf, dtype=np.float32)
        out[".".join(path[:-1] + (_STAT_LEAVES[path[-1]],))] = torch.from_numpy(
            arr.copy()
        )
        if path[-1] == "var":
            out[".".join(path[:-1] + ("num_batches_tracked",))] = torch.tensor(0)
    return out
