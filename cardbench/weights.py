"""Raw state dicts (BatchNorm unfolded) made from the seed, on the device.

The keys and shapes come from the reference model built on the meta
device; the program's modules carry the same names.  Every value of one
model comes from one ``randn`` and one ``rand`` call of a generator on the
device, mapped per leaf by an affine map:

* conv and linear weights: N(0, 1 / fan_in) (lecun normal);
* conv and linear biases: N(0, 0.1^2);
* BatchNorm weight U(0.5, 1.5), bias N(0, ``bn_bias_std``^2), running
  mean N(0, 0.1^2), running variance U(0.5, 1.5); ``num_batches_tracked``
  0;
* LayerNorm weight U(0.5, 1.5), bias N(0, 0.1^2) (a gain drawn as a
  linear weight of fan-in 1 would be N(0, 1), half of it negative);
* the output layers scaled, and the detector's class biases centred per
  class and shifted, as the constants below and :func:`make_states` say;

then each BatchNorm's running statistics are set to those of its input on
seeded frames (:func:`make_states`), as a trained network's are: with
unit-scale statistics a deep random network's signal vanishes and its
detection scores all but tie.
"""

from __future__ import annotations

import math
import struct
from typing import Dict

import torch
from torch import nn

from cardbench.reference.two_stage import build_model, crop
from cardbench.traffic import make_frames, seed_of

# BatchNorm shifts N(0, 5^2) and running variances floored at 0.6 of their
# layer's mean keep a random network's rounding errors from growing through
# its depth: a bf16 copy's logits part from float32's by 1.4-2.4% of their
# spread (detectors) and 0.5-0.7% (classifiers), against 24-76% and up to 32%
# with shifts of 0.1 and unfloored variances (seeded CPU probes at 640 and
# 64x64 crops)
BN_BIAS_STD = 5.0
# but not in attention's q, k and v (YOLO11's C2PSA): shifted by 5, q . k /
# sqrt(d) reaches ~140 and the softmax is one-hot, its argmax flipped by any
# rounding; unshifted, the attention logits' spread is ~1
ATTENTION_BN_BIAS_STD = 0.1
VAR_FLOOR = 0.6
# output layers scaled to these logit spreads on the calibration inputs, and
# the class logits shifted so that one anchor in POSITIVE_SHARE scores above
# 0.5: a trained detector scores most anchors near 0, and logits of a few
# units keep the DFL bins and the softmaxes from saturating, where a random
# network's bf16 rounding would swing them
REG_LOGIT_STD = 1.0
CLS_LOGIT_STD = 1.5
LABEL_LOGIT_STD = 1.0
POSITIVE_SHARE = 0.01
CALIBRATION_FRAMES = 4
CALIBRATION_CROPS = 64
CALIBRATION_FIRST = 1 << 40  # frame index of the calibration frames, apart from any pool
TORCH_QUANTILE_MAX = 1 << 24  # torch.quantile refuses more values
COUNT_CHUNK = 1 << 24  # values compared at once while counting

# (randn scale, rand scale, offset) per kind of leaf
_MAPS = {
    "bias": (0.1, 0.0, 0.0),
    "bn_weight": (0.0, 1.0, 0.5),
    "running_mean": (0.1, 0.0, 0.0),
    "running_var": (0.0, 1.0, 0.5),
}


def _kind(model: nn.Module, key: str):
    mod_name, _, leaf = key.rpartition(".")
    mod = model.get_submodule(mod_name)
    if isinstance(mod, nn.BatchNorm2d):
        return {"weight": "bn_weight", "bias": "bn_bias"}.get(leaf, leaf)
    if isinstance(mod, nn.LayerNorm):
        return "bn_weight" if leaf == "weight" else "bias"
    return "weight" if leaf == "weight" else "bias"


def raw_state(spec: dict, seed: int, device, salt: int,
              bn_bias_std: float) -> Dict[str, torch.Tensor]:
    """The float32 raw state dict of the model ``spec`` describes, drawn
    under ``salt`` (one per model of a configuration)."""
    with torch.device("meta"):
        model = build_model(spec)
    entries = [(k, v.shape, _kind(model, k)) for k, v in model.state_dict().items()]
    floats = [(k, shape, kind) for k, shape, kind in entries if kind != "num_batches_tracked"]
    numels = torch.tensor([shape.numel() for _, shape, _ in floats])
    a, b, c = [], [], []
    for k, shape, kind in floats:
        if kind == "weight":
            fan_in = shape[1:].numel() if len(shape) > 1 else 1
            a.append(fan_in ** -0.5), b.append(0.0), c.append(0.0)
        elif kind == "bn_bias":
            a.append(ATTENTION_BN_BIAS_STD if ".attn.qkv." in k else bn_bias_std)
            b.append(0.0), c.append(0.0)
        else:
            ra, rb, rc = _MAPS[kind]
            a.append(ra), b.append(rb), c.append(rc)
    total = int(numels.sum())
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, salt))
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    per = [torch.tensor(v, device=device).repeat_interleave(numels.to(device)) for v in (a, b, c)]
    flat = normal * per[0] + uniform * per[1] + per[2]
    state = {}
    for (k, shape, _), part in zip(floats, torch.split(flat, numels.tolist())):
        state[k] = part.view(shape)
    for k, _, kind in entries:
        if kind == "num_batches_tracked":
            state[k] = torch.zeros((), dtype=torch.long, device=device)
    return {k: state[k] for k, _, _ in entries}


@torch.no_grad()
def calibrate_batchnorm(model: nn.Module, state: Dict[str, torch.Tensor], x: torch.Tensor,
                        device) -> Dict[str, torch.Tensor]:
    """``state`` with every BatchNorm's running mean and variance set to
    the statistics of its own input when ``model`` (float32, with
    ``state`` loaded) runs on ``x``, each layer after the ones before it
    (variances floored at :data:`VAR_FLOOR` of the layer's mean): as a
    trained network's statistics match its activations, so that the signal
    neither vanishes nor explodes through the depth."""
    model = model.to(device).eval()
    model.load_state_dict(state)
    out = {}

    def hook(mod, args):
        inp = args[0].float()
        var = inp.var(dim=(0, 2, 3), unbiased=False)
        mod.running_mean.copy_(inp.mean(dim=(0, 2, 3)))
        mod.running_var.copy_(torch.clamp(var, min=VAR_FLOOR * float(var.mean())))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, nn.BatchNorm2d)]
    try:
        out["y"] = model(x)
    finally:
        for h in handles:
            h.remove()
    calibrated = model.state_dict()
    state = {k: calibrated[k].detach().clone() if k.endswith(("running_mean", "running_var"))
             else v for k, v in state.items()}
    return state, out["y"]


def _key(bits: int) -> int:
    """A float32 bit pattern as an integer that orders as the values do."""
    return bits ^ 0xFFFFFFFF if bits & 0x80000000 else bits | 0x80000000


def _value(key: int) -> float:
    bits = key & 0x7FFFFFFF if key & 0x80000000 else key ^ 0xFFFFFFFF
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def _count(values: torch.Tensor, test) -> int:
    """How many of ``values`` pass ``test``, a chunk at a time (no
    full-size temporary)."""
    return int(sum(test(c).sum() for c in values.split(COUNT_CHUNK)))


def order_statistic(values: torch.Tensor, k: int) -> float:
    """The ``k``-th smallest (from 0) of the 1-D float32 ``values``, which
    hold no NaN: the least float32 ``t`` with more than ``k`` values at or
    below it, found by bisection over the ordered bit patterns from -inf
    to +inf (32 counts)."""
    lo, hi = _key(0xFF800000), _key(0x7F800000)
    while lo < hi:
        mid = (lo + hi) // 2
        t = _value(mid)
        if _count(values, lambda c: c <= t) > k:
            hi = mid
        else:
            lo = mid + 1
    return _value(lo)


def quantile(values: torch.Tensor, q: float, limit: int = TORCH_QUANTILE_MAX) -> torch.Tensor:
    """``torch.quantile(values, q)`` (linear interpolation) of float32
    ``values`` at any size, on their device.

    Up to ``limit`` values it is that call.  Above, the same definition over
    all the values, no sample: the order statistics at the floor and the
    ceiling of ``q * (n - 1)`` (:func:`order_statistic`, no copy of
    ``values``), interpolated by the rank's fraction.  Where torch.quantile
    would take the input (n <= 2^24) the rank, the weight and the
    interpolation are its own float32 operations, so a call forced below
    its limit equals it bit for bit; beyond, they are float64 (float32
    holds no rank there), the result rounded once to float32.  NaN where
    any value is NaN, as torch.quantile."""
    values = values.flatten()
    n = values.numel()
    if n <= limit:
        return torch.quantile(values, q)
    if values.dtype != torch.float32:
        raise TypeError(f"quantile takes float32 values, not {values.dtype}")
    if _count(values, torch.isnan):
        return torch.tensor(float("nan"), device=values.device)
    as_torch = n <= TORCH_QUANTILE_MAX
    rank = torch.tensor(q, dtype=torch.float32) * (n - 1) if as_torch else q * (n - 1)
    lo, hi = math.floor(rank), math.ceil(rank)
    below = order_statistic(values, lo)
    above = below
    if hi > lo and _count(values, lambda c: c <= below) <= hi:  # the least value above
        above = min(float(torch.where(c > below, c, math.inf).min())
                    for c in values.split(COUNT_CHUNK))
    if as_torch:
        return torch.lerp(torch.tensor(below, device=values.device),
                          torch.tensor(above, device=values.device),
                          (rank - lo).to(values.device))
    value = below + (rank - lo) * (above - below)
    return torch.tensor(value, dtype=torch.float32, device=values.device)


def head_keys(spec: dict, branch: str):
    """The weight and bias keys of a detector head's ``branch`` ("reg" or
    "cls") output convs, every level."""
    names = _names(spec)
    return [k for i in range(len(spec.get("strides", ())))
            for p in (f"head.{branch}{i}_out", f"{branch}{i}_out")
            for k in (f"{p}.weight", f"{p}.bias") if k in names]


def _scale(state, keys, factor):
    for k in keys:
        state[k] = state[k] * factor


def _names(spec: dict):
    with torch.device("meta"):
        return set(build_model(spec).state_dict())


def make_states(config: dict, seed: int, device):
    """(detector, classifier) raw state dicts of ``config`` for ``seed``,
    BatchNorm and the output layers calibrated on seeded frames at the
    detector's input size and on seeded crops of them."""
    det_spec, cls_spec = config["detector"], config["classifier"]
    det = raw_state(det_spec, seed, device, 1, BN_BIAS_STD)
    cls = raw_state(cls_spec, seed, device, 2, BN_BIAS_STD)
    s = det_spec["input_size"]
    frames = make_frames(seed, CALIBRATION_FIRST, CALIBRATION_FRAMES, s, s, device)
    x = frames.permute(0, 3, 1, 2).float() * (1.0 / 255.0)
    if config["serving"]["input_color"] == "bgr":
        x = x.flip(1)
    det, head = calibrate_batchnorm(build_model(det_spec), det, x, device)
    _scale(det, head_keys(det_spec, "reg"), REG_LOGIT_STD / float(head["reg"].std()))
    # each level's class logits centred per class over the calibration
    # anchors (in place): a random head gives every class an offset of its
    # own (its weights against the features' mean), wider than the logits'
    # spread across anchors, so that one class would win at every anchor,
    # where a trained detector's class follows the image.  With one class
    # the offset is exactly 0.
    logits = head["cls"].float()
    levels = logits.split([(s // st) ** 2 for st in det_spec["strides"]], dim=1)
    biases = [k for k in head_keys(det_spec, "cls") if k.endswith(".bias")]
    for key, level in zip(biases, levels, strict=True):
        mean = level.mean(dim=(0, 1))
        offset = mean - mean.mean()
        level.sub_(offset)
        det[key] = det[key] - offset
    cls_factor = CLS_LOGIT_STD / float(logits.std())
    _scale(det, head_keys(det_spec, "cls"), cls_factor)
    shift = quantile(logits.flatten() * cls_factor, 1.0 - POSITIVE_SHARE)
    for k in head_keys(det_spec, "cls"):
        if k.endswith(".bias"):
            det[k] = det[k] - shift
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, 4))
    n = CALIBRATION_CROPS
    xy = torch.rand((n, 2), generator=gen, device=device) * (s * 0.8)
    wh = 8.0 + torch.rand((n, 2), generator=gen, device=device) * (s * 0.2)
    image = torch.randint(0, CALIBRATION_FRAMES, (n,), generator=gen, device=device)
    crops = crop(frames, image, torch.cat([xy, xy + wh], 1), cls_spec["input_size"]) / 255.0
    if config["serving"]["input_color"] == "bgr":
        crops = crops.flip(-1)
    mean = torch.tensor(cls_spec["mean"], device=device)
    std = torch.tensor(cls_spec["std"], device=device)
    crops = ((crops - mean) / std).permute(0, 3, 1, 2).contiguous()
    cls, logits = calibrate_batchnorm(build_model(cls_spec), cls, crops, device)
    _scale(cls, ("fc.weight", "fc.bias"), LABEL_LOGIT_STD / float(logits.std()))
    return det, cls
