"""Fold inference BatchNorm into conv weights/biases (deploy-form weights).

On ``state_dict``s of the port's modules, with the JAX package's formula::

    s  = gamma / sqrt(running_var + eps)
    W' = W * s          (per output channel: dim 0 of OIHW)
    b' = b * s + beta - running_mean * s      (b = 0 without a conv bias)

in float32 numpy, as the JAX package folds, so the folded weights equal
its bit for bit (numpy's sqrt is correctly rounded; torch's vectorised CPU
sqrt is not always).  Detector ConvBNs use eps 1e-3, the classifiers 1e-5
(``models/layers.py::CLASSIFIER_BN_EPS``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

BN_EPS = 1e-3  # models/layers.py ConvBN's BatchNorm epsilon

StateDict = Dict[str, torch.Tensor]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def has_batchnorm(state: StateDict) -> bool:
    """True when the state dict still carries BatchNorm running statistics."""
    return any(k.endswith(".running_var") for k in state)


def fold_batchnorm(state: StateDict, eps: float = BN_EPS) -> StateDict:
    """Deploy-form state: every BatchNorm ``<p>bnX`` with a ``<p>convX``
    sibling (``bn``/``conv`` in the ConvBN units, ``bn1``/``conv1`` in
    ResNet18's stem) becomes a biased conv and the ``<p>bnX.*`` entries
    disappear.  Entries without a bn sibling (plain output convs, linear
    layers) pass through.  Raises on a BatchNorm with no conv sibling."""
    out = dict(state)
    for key in state:
        if not key.endswith(".running_var"):
            continue
        bn = key[: -len(".running_var")]
        prefix, dot, name = bn.rpartition(".")
        conv = f"{prefix}{dot}conv{name[2:]}"
        if not name.startswith("bn") or f"{conv}.weight" not in state:
            raise ValueError(f"unfoldable BatchNorm at '{bn}': no conv sibling")
        gamma, beta, mean, var, w = (
            _np(state[k])
            for k in (f"{bn}.weight", f"{bn}.bias", f"{bn}.running_mean",
                      f"{bn}.running_var", f"{conv}.weight")
        )
        s = gamma / np.sqrt(var + np.float32(eps))
        base = state.get(f"{conv}.bias")
        base = np.zeros_like(s) if base is None else _np(base)
        out[f"{conv}.weight"] = torch.from_numpy(
            w * s.reshape(-1, *([1] * (w.ndim - 1)))
        )
        out[f"{conv}.bias"] = torch.from_numpy(base * s + beta - mean * s)
        for k in [k for k in out if k.startswith(f"{bn}.")]:
            del out[k]
    return out


def fold_pipeline_state(state: StateDict, eps: float = BN_EPS) -> StateDict:
    """Pipeline helper: the deploy-form state.  A state without BN
    statistics must already be deploy-form."""
    if has_batchnorm(state):
        return fold_batchnorm(state, eps)
    if any(".bn." in k for k in state):
        raise ValueError("BatchNorm parameters without running statistics")
    return dict(state)


def fold_stem_input(weight: torch.Tensor, scale: float, flip_channels: bool) -> torch.Tensor:
    """Fold an input-side scale and channel flip into a conv kernel (OIHW):
    ``conv(flip(x) * s, W) == conv(x, flip_cin(W) * s)``, exact including
    zero padding.  The fused pipeline feeds the stem raw 0-255 pixels in
    the host's colour order with this kernel.  Only valid on deploy-form
    (BN-folded) weights."""
    if flip_channels:
        weight = weight.flip(1)
    return weight * scale


def stem_kernel_hwio(weight: torch.Tensor, flip_channels: bool) -> torch.Tensor:
    """The deploy-form stem weight (C, 3, 3, 3) OIHW as the stem kernel's
    (3, 3, 3, C) HWIO float32 kernel (``ops/stem.py::fused_stem``), with
    the 1/255 input scale and, for BGR frames, the channel flip folded in:
    the kernel ``pallas_stem`` takes, for raw 0-255 frames."""
    folded = fold_stem_input(weight.float(), 1.0 / 255.0, flip_channels)
    return folded.permute(2, 3, 1, 0).contiguous()
