"""Fold inference BatchNorm into conv weights/biases (deploy-form weights).

On ``state_dict``s of the port's modules, with the JAX package's formula::

    s  = gamma / sqrt(running_var + eps)
    W' = W * s          (per output channel: dim 0 of OIHW)
    b' = b * s + beta - running_mean * s      (b = 0 without a conv bias)

in float32 numpy, as the JAX package folds, so the folded weights equal
its bit for bit (numpy's sqrt is correctly rounded; torch's vectorised CPU
sqrt is not always).  Detector ConvBNs use eps 1e-3, the classifiers 1e-5
(``models/layers.py::CLASSIFIER_BN_EPS``).

The same fold on Flax-named variable trees (nested dicts of numpy arrays,
as the importers return them), :func:`fold_pipeline_vars` and
:func:`fold_detector_pipeline_vars`, copies the JAX package's tree form
line for line, for the graph emitters (``weights/*_export.py``), so their
folded weights and emitted bytes equal the JAX emitters'.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

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


def _fold_branch(state: StateDict, prefix: str, eps: float):
    """(W * s, beta - mean * s) of the bias-free ConvBN ``prefix``, float32
    numpy."""
    gamma, beta, mean, var, w = (
        _np(state[f"{prefix}.{k}"])
        for k in ("bn.weight", "bn.bias", "bn.running_mean", "bn.running_var", "conv.weight"))
    s = gamma / np.sqrt(var + np.float32(eps))
    return w * s.reshape(-1, 1, 1, 1), beta - mean * s


def fold_repconvs(state: StateDict, prefixes, eps: float = BN_EPS) -> StateDict:
    """Re-parameterised state: each RepConv ``<p>`` of ``prefixes`` (a 3x3
    ConvBN ``<p>.conv1`` and a 1x1 ConvBN ``<p>.conv2``, both bias-free and
    summed) becomes one biased 3x3 conv ``<p>.conv``: each branch folded as
    :func:`fold_batchnorm` folds, the 1x1 kernel zero-padded to the centre of
    a 3x3 one, kernels and biases summed, in float32 numpy (Ultralytics'
    ``RepConv.fuse_convs``).  Every other entry passes through unchanged."""
    out = dict(state)
    for p in prefixes:
        w3, b3 = _fold_branch(state, f"{p}.conv1", eps)
        w1, b1 = _fold_branch(state, f"{p}.conv2", eps)
        w = w3.copy()
        w[:, :, 1:2, 1:2] += w1
        out[f"{p}.conv.weight"] = torch.from_numpy(w)
        out[f"{p}.conv.bias"] = torch.from_numpy(b3 + b1)
        for k in [k for k in out if k.startswith((f"{p}.conv1.", f"{p}.conv2."))]:
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


# ---------------------------------------------------------------------- #
# the fold on Flax-named variable trees                                   #
# ---------------------------------------------------------------------- #


def has_batchnorm_vars(variables: Dict[str, Any]) -> bool:
    """True when the variable tree still carries BatchNorm statistics."""
    return bool(variables.get("batch_stats"))


def fold_batchnorm_vars(variables: Dict[str, Any], eps: float = BN_EPS) -> Dict[str, Any]:
    """Deploy-form variables: every ``{convX, bnX}`` sibling pair in
    ``params`` (with matching running stats in ``batch_stats``) becomes a
    biased ``convX``; the ``batch_stats`` collection disappears.  Nodes
    without a bn sibling pass through; a tree without statistics is
    returned as it is.  Raises on a BatchNorm with no conv sibling."""
    if not has_batchnorm_vars(variables):
        return {"params": variables["params"]} if "params" in variables else variables

    def contains_stats(node: Dict[str, Any]) -> bool:
        return "mean" in node or any(
            isinstance(v, dict) and contains_stats(v) for v in node.values()
        )

    def fold(params: Dict[str, Any], stats: Dict[str, Any]) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(params)
        keys = set(params) | set(stats)
        folded_bns = set()
        for k in list(params):
            if not k.startswith("bn"):
                continue
            conv_key = "conv" + k[2:]
            bn_p, bn_s = params.get(k), stats.get(k)
            if (
                conv_key in params
                and isinstance(bn_p, dict)
                and isinstance(bn_s, dict)
                and "scale" in bn_p
                and "var" in bn_s
            ):
                s = np.asarray(bn_p["scale"]) / np.sqrt(np.asarray(bn_s["var"]) + eps)
                conv = dict(params[conv_key])
                # Flax conv kernels are (kh, kw, cin/groups, cout): scale cout
                conv["kernel"] = np.asarray(conv["kernel"]) * s
                # BN(conv(x)+b) = s*(conv(x)+b-mean)+beta: a conv bias scales by s
                base = np.asarray(conv["bias"]) if "bias" in conv else 0.0
                conv["bias"] = base * s + np.asarray(bn_p["bias"]) - np.asarray(bn_s["mean"]) * s
                out[conv_key] = conv
                del out[k]
                folded_bns.add(k)
        for k in keys:
            if k in folded_bns:
                continue
            p, st = out.get(k), stats.get(k)
            if isinstance(p, dict) and isinstance(st, dict):
                out[k] = fold(p, st)
            elif p is None and isinstance(st, dict) and contains_stats(st):
                raise ValueError(f"unfoldable BatchNorm at '{k}': no conv sibling")
        return out

    return {"params": fold(variables["params"], variables["batch_stats"])}


def fold_pipeline_vars(
    variables: Dict[str, Any], eps: float = BN_EPS
) -> Tuple[Dict[str, Any], bool]:
    """``(variables, fused)``: the folded tree when it carries statistics;
    else the tree as it is, ``fused`` False when its params still hold a
    ``bn`` node (BN parameters without statistics), True otherwise."""
    if has_batchnorm_vars(variables):
        return fold_batchnorm_vars(variables, eps=eps), True
    params = variables.get("params", {})

    def any_bn(node) -> bool:
        if not isinstance(node, dict):
            return False
        return "bn" in node or any(any_bn(v) for v in node.values())

    return variables, not any_bn(params)


def fold_detector_pipeline_vars(variables: Dict[str, Any]) -> Tuple[Dict[str, Any], bool]:
    """:func:`fold_pipeline_vars` at the detector ConvBN's eps 1e-3."""
    return fold_pipeline_vars(variables, eps=BN_EPS)
