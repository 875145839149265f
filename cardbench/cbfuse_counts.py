"""Bytes of YOLOv9-E's ``CBFuse`` fan-ins, from a configuration's file
(``configs/<name>.json``).

Each call of a fan-in (one ``CBFuse`` of the reference detector,
``reference/yolov9.py``) resizes each of its sources (a split of a
``CBLinear`` output) to its target's size by nearest neighbour and sums
them with the target.  One pass reads each source and the target once and
writes the output once, in bf16; its few adds per value are nothing beside
those bytes, so its least time on the card is the bytes over HBM
bandwidth.
"""

from __future__ import annotations

import json
from typing import List, Sequence, Tuple

import torch

from cardbench import spec, yardstick
from cardbench.reference.two_stage import build_model

BF16_BYTES = 2

Shape = Tuple[int, ...]


def calls(detector: dict, batch: int) -> List[Tuple[List[Shape], Shape]]:
    """(source shapes, target shape) of each fan-in call, in call order, of
    the reference detector ``detector`` (a configuration's ``detector``
    entry) on a batch of ``batch`` canvases: each ``CBFuse``'s inputs read
    while the model runs on the meta device."""
    with torch.device("meta"):
        model = build_model(detector)
    found = []

    def hook(mod, args):
        xs = args[0]
        found.append(([tuple(x[i].shape) for x, i in zip(xs[:-1], mod.idx)],
                      tuple(xs[-1].shape)))

    for m in model.modules():
        if type(m).__name__ == "CBFuse":
            m.register_forward_pre_hook(hook)
    s = detector["input_size"]
    with torch.no_grad():
        model(torch.zeros((batch, 3, s, s), device="meta"))
    return found


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def bytes_of(sources: Sequence[Shape], target: Shape) -> float:
    """Bytes one pass of a call moves: every source and the target read
    once, the output (the target's size) written once, in bf16."""
    return float((sum(_numel(s) for s in sources) + 2 * _numel(target)) * BF16_BYTES)


def bound_s(config: str, batch: int) -> float:
    """The least time of one batch's fan-ins under the configuration
    ``config``: their bytes over 3.35 TB/s."""
    detector = json.loads((spec.HERE / "configs" / f"{config}.json").read_text())["detector"]
    return sum(bytes_of(*c) for c in calls(detector, batch)) / yardstick.HBM_BYTES_PER_S
