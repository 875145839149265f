"""Operations and bytes of YOLO-World's max-sigmoid text-attention cores,
from a configuration's file (``configs/<name>.json``).

Each call of a core (one ``MaxSigmoidAttn`` of the reference detector,
``reference/yoloworld.py``) scores every pixel of a (B, c, H, W) input
against ``nc`` classes in ``heads`` heads of 32 channels: 2 * B * H * W * nc
* c operations (one multiply-add per channel, class and pixel), and at
least x's c channels, the guides (heads * nc * 32 values) and the (B,
heads, H, W) weights moved once, in bf16.  Its least time on the card is
the larger of the operations over the bf16 peak and the bytes over HBM
bandwidth.
"""

from __future__ import annotations

import json
from typing import List, Tuple

import torch

from cardbench import spec, yardstick
from cardbench.reference.two_stage import build_model

BF16_BYTES = 2


def calls(detector: dict, batch: int) -> List[Tuple[int, int, int, int, int, int]]:
    """(B, heads, H, W, nc, c) of each core call, in call order, of the
    reference detector ``detector`` (a configuration's ``detector`` entry)
    on a batch of ``batch`` canvases: each ``MaxSigmoidAttn``'s input shape
    read while the model runs on the meta device."""
    with torch.device("meta"):
        model = build_model(detector)
    found = []

    def hook(mod, args):
        b, c, h, w = args[0].shape
        found.append((b, mod.nh, h, w, mod.nc, c))

    for m in model.modules():
        if type(m).__name__ == "MaxSigmoidAttn":
            m.register_forward_pre_hook(hook)
    s = detector["input_size"]
    with torch.no_grad():
        model(torch.zeros((batch, 3, s, s), device="meta"))
    return found


def counts(b: int, heads: int, h: int, w: int, nc: int, c: int) -> Tuple[float, float]:
    """(operations, bytes) of one call."""
    ops = 2.0 * b * h * w * nc * c
    n_bytes = (b * c * h * w + heads * nc * 32 + b * heads * h * w) * BF16_BYTES
    return ops, float(n_bytes)


def bound_s(config: str, batch: int) -> float:
    """The least time of one batch's max-sigmoid cores under the
    configuration ``config``: per call the larger of its operations over
    989 TFLOP/s and its bytes over 3.35 TB/s, summed."""
    detector = json.loads((spec.HERE / "configs" / f"{config}.json").read_text())["detector"]
    total = 0.0
    for c in calls(detector, batch):
        ops, n_bytes = counts(*c)
        total += max(ops / yardstick.BF16_FLOPS, n_bytes / yardstick.HBM_BYTES_PER_S)
    return total
