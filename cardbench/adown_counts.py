"""Bytes of YOLOv9-E's ``ADown`` front ends, from a configuration's file
(``configs/<name>.json``).

Each call of an ``ADown`` (of the reference detector, ``reference/
yolov9.py``) takes the 2x2 stride-1 average pool of its input, sends the
first half of the pooled channels to one conv and the 3x3/2 max pool of
the second half to the other.  One pass reads the input once and writes
the first half's averages (B, C/2, H-1, W-1) and the second half's pooled
map (B, C/2, (H-2)//2 + 1, (W-2)//2 + 1) once, in bf16; its few operations
per value are nothing beside those bytes, so its least time on the card is
the bytes over HBM bandwidth.
"""

from __future__ import annotations

import json
from typing import List, Tuple

import torch

from cardbench import spec, yardstick
from cardbench.reference.two_stage import build_model

BF16_BYTES = 2

Shape = Tuple[int, int, int, int]


def calls(detector: dict, batch: int) -> List[Shape]:
    """The input shape (B, C, H, W) of each ``ADown`` call, in call order,
    of the reference detector ``detector`` (a configuration's ``detector``
    entry) on a batch of ``batch`` canvases, read while the model runs on
    the meta device."""
    with torch.device("meta"):
        model = build_model(detector)
    found = []
    for m in model.modules():
        if type(m).__name__ == "ADown":
            m.register_forward_pre_hook(lambda mod, args: found.append(tuple(args[0].shape)))
    s = detector["input_size"]
    with torch.no_grad():
        model(torch.zeros((batch, 3, s, s), device="meta"))
    return found


def bytes_of(shape: Shape) -> float:
    """Bytes one pass of a call on an input of ``shape`` moves: the input
    read once, the two halves' outputs written once, in bf16."""
    b, c, h, w = shape
    half = b * (c // 2)
    return float((b * c * h * w + half * (h - 1) * (w - 1)
                  + half * ((h - 2) // 2 + 1) * ((w - 2) // 2 + 1)) * BF16_BYTES)


def bound_s(config: str, batch: int) -> float:
    """The least time of one batch's ADown front ends under the
    configuration ``config``: their bytes over 3.35 TB/s."""
    detector = json.loads((spec.HERE / "configs" / f"{config}.json").read_text())["detector"]
    return sum(bytes_of(c) for c in calls(detector, batch)) / yardstick.HBM_BYTES_PER_S
