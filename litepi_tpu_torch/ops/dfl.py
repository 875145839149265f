"""Distribution Focal Loss (DFL) box decode and top-k candidate selection.

The exported reference graph reshapes the 64-channel regression output to
(4 sides, 16 bins), softmaxes over bins and takes the expectation, then adds
the anchor point and multiplies by the stride.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def dfl_decode(reg_logits: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """(..., A, 4 * reg_max) raw logits (bin-major per side) -> (..., A, 4)
    distances (l, t, r, b) in feature-map units, computed in float32."""
    shape = reg_logits.shape[:-1] + (4, reg_max)
    logits = reg_logits.reshape(shape).float()
    probs = torch.softmax(logits, dim=-1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=logits.device)
    return torch.sum(probs * bins, dim=-1)


def decode_boxes(
    distances: torch.Tensor,
    anchor_points: torch.Tensor,
    strides: torch.Tensor,
    xywh: bool = True,
) -> torch.Tensor:
    """(l, t, r, b) distances (..., A, 4) -> boxes in input pixels, given
    anchor_points (..., A, 2) and strides (..., A, 1)."""
    lt, rb = distances[..., :2], distances[..., 2:]
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        c = (x1y1 + x2y2) * 0.5
        wh = x2y2 - x1y1
        return torch.cat([c, wh], dim=-1) * strides
    return torch.cat([x1y1, x2y2], dim=-1) * strides


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` along the last axis, descending, ties to the lower index
    (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def decode_candidates(
    head_out: Dict[str, torch.Tensor],
    anchor_points: torch.Tensor,
    strides: torch.Tensor,
    reg_max: int = 16,
    k: int = 512,
    selector: str = "exact",
):
    """Top-``k`` score-descending candidates from a ``{reg, cls}`` head
    output: (boxes (B, K, 4) xyxy input pixels, scores (B, K), class_ids
    (B, K) int32).

    Scores are sigmoid class maxima in float32; class ids are the first
    maximal class.  Only the K selected rows of ``reg`` are DFL-decoded:
    the decode is row-wise, so this gives the same numbers as decoding all
    anchors and gathering.

    ``selector="approx"`` names the TPU's ``approx_max_k``, which has no
    counterpart here; it is accepted and runs the exact selection.
    """
    if selector not in ("exact", "approx"):
        raise ValueError(f"unknown candidate selector {selector!r}")
    probs = torch.sigmoid(head_out["cls"].float())
    scores = probs.amax(dim=-1)
    class_ids = probs.argmax(dim=-1).to(torch.int32)
    k = min(k, scores.shape[-1])
    top_scores, idx = topk_stable(scores, k)
    reg = head_out["reg"]
    reg_top = torch.gather(
        reg, 1, idx[..., None].expand(-1, -1, reg.shape[-1])
    )
    dist = dfl_decode(reg_top, reg_max)
    boxes = decode_boxes(dist, anchor_points[idx], strides[idx], xywh=False)
    cls_top = torch.gather(class_ids, 1, idx)
    return boxes, top_scores, cls_top
