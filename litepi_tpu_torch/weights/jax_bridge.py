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

:func:`state_dict_to_jax` is the inverse: a trained model's ``state_dict``
leaves as the Flax-named tree that the checkpoint, the emitters and the
e2e CLI take.
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


def _unkernel(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4:  # OIHW -> HWIO (depthwise (C, 1, kh, kw) -> (kh, kw, 1, C))
        return arr.transpose(2, 3, 1, 0)
    if arr.ndim == 2:  # Linear (out, in) -> Dense (in, out)
        return arr.T
    raise ValueError(f"unexpected weight rank {arr.ndim}")


def _put(tree: Dict[str, Any], path: Tuple[str, ...], leaf: np.ndarray) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def state_dict_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``state_dict`` as a Flax variable tree of float32 numpy
    arrays, ``{"params": ..., "batch_stats": ...}`` (no ``batch_stats``
    where the state has no BatchNorm), the inverse of
    :func:`jax_to_state_dict`: a 4-D or 2-D ``weight`` is a kernel, a 1-D
    one a ``scale`` (a BatchNorm's, or SSD300's ``L2Norm``);
    ``num_batches_tracked`` has no Flax counterpart and is dropped."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, value in state.items():
        module, leaf = key.rsplit(".", 1)
        path = tuple(module.split("."))
        arr = value.detach().cpu().float().numpy()
        if leaf == "num_batches_tracked":
            continue
        if leaf in ("running_mean", "running_var"):
            _put(stats, path + ({"running_mean": "mean", "running_var": "var"}[leaf],), arr.copy())
        elif leaf == "weight" and arr.ndim == 1:
            _put(params, path + ("scale",), arr.copy())
        elif leaf == "weight":
            _put(params, path + ("kernel",), np.ascontiguousarray(_unkernel(arr)))
        elif leaf == "bias":
            _put(params, path + ("bias",), arr.copy())
        else:
            raise ValueError(f"unexpected state entry {key}")
    out: Dict[str, Any] = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out
