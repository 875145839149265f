"""Operations and bytes of YOLO12's area-attention cores, from a
configuration's file (``configs/<name>.json``).

Each call of an attention core (one ``AAttn`` of the reference detector,
``reference/yolo12.py``) attends ``sequences`` = B * area chunks of ``n`` =
H * W / area tokens in ``heads`` heads of ``d`` channels.  Per head and
chunk it needs 4 * n^2 * d operations (two n x n x d products, 2 per
multiply-add) and moves q, k and v once in and the output once out, 4 * n
* d bf16 values.  Its least time on the card is the larger of the
operations over the bf16 peak and the bytes over HBM bandwidth.
"""

from __future__ import annotations

import json
from typing import List, Tuple

import torch

from cardbench import spec, yardstick
from cardbench.reference.two_stage import build_model

BF16_BYTES = 2


def calls(detector: dict, batch: int) -> List[Tuple[int, int, int, int]]:
    """(sequences, heads, n, d) of each attention-core call, in call order,
    of the reference detector ``detector`` (a configuration's
    ``detector`` entry) on a batch of ``batch`` canvases: each ``AAttn``'s
    input shape read while the model runs on the meta device."""
    with torch.device("meta"):
        model = build_model(detector)
    found = []

    def hook(mod, args):
        b, _, h, w = args[0].shape
        found.append((b * mod.area, mod.num_heads, h * w // mod.area, mod.head_dim))

    for m in model.modules():
        if type(m).__name__ == "AAttn":
            m.register_forward_pre_hook(hook)
    s = detector["input_size"]
    with torch.no_grad():
        model(torch.zeros((batch, 3, s, s), device="meta"))
    return found


def counts(seqs: int, heads: int, n: int, d: int) -> Tuple[float, float]:
    """(operations, bytes) of one call."""
    return 4.0 * seqs * heads * n * n * d, 4.0 * seqs * heads * n * d * BF16_BYTES


def bound_s(config: str, batch: int) -> float:
    """The least time of one batch's attention cores under the
    configuration ``config``: per call the larger of its operations over
    989 TFLOP/s and its bytes over 3.35 TB/s, summed."""
    detector = json.loads((spec.HERE / "configs" / f"{config}.json").read_text())["detector"]
    total = 0.0
    for c in calls(detector, batch):
        ops, n_bytes = counts(*c)
        total += max(ops / yardstick.BF16_FLOPS, n_bytes / yardstick.HBM_BYTES_PER_S)
    return total
