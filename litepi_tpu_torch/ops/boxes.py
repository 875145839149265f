"""Box coordinate math on ``(..., 4)`` xyxy tensors."""

from __future__ import annotations

import torch

EPS = 1e-6  # the reference's IoU denominator epsilon


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes, clamped at zero."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return w * h


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU between ``a`` (..., M, 4) and ``b`` (..., N, 4) ->
    (..., M, N), with the reference's +eps denominator.

    Areas are clamped at zero, as the NMS kernel clamps them; the JAX
    package's ``box_iou`` does not, which differs only for boxes with
    x2 < x1 or y2 < y1 (DFL decode never emits them).
    """
    a = a[..., :, None, :]
    b = b[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a) + box_area(b) - inter + EPS
    return inter / union


def clip_boxes(boxes: torch.Tensor, w, h) -> torch.Tensor:
    """Clip xyxy boxes to [0, w] x [0, h] (scalar bounds)."""
    x1 = torch.clamp(boxes[..., 0], 0.0, float(w))
    y1 = torch.clamp(boxes[..., 1], 0.0, float(h))
    x2 = torch.clamp(boxes[..., 2], 0.0, float(w))
    y2 = torch.clamp(boxes[..., 3], 0.0, float(h))
    return torch.stack([x1, y1, x2, y2], dim=-1)


def unletterbox_boxes(boxes: torch.Tensor, ratio: float, dw: float, dh: float,
                      orig_w: int, orig_h: int) -> torch.Tensor:
    """Map xyxy boxes from letterboxed 640-space back to original pixels
    and clip, as the reference postprocess does: shift by (dw, dh), divide
    by ``ratio``, clip to [0, orig_w] x [0, orig_h].  ``ratio`` divides as
    a tensor: a CUDA divide by a Python float multiplies by its reciprocal,
    where JAX divides."""
    shift = torch.tensor([dw, dh, dw, dh], dtype=boxes.dtype, device=boxes.device)
    ratio_t = torch.tensor(ratio, dtype=boxes.dtype, device=boxes.device)
    return clip_boxes((boxes - shift) / ratio_t, orig_w, orig_h)


def box_iou_signed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``box_iou``, which the baselines' losses match
    with: pairwise IoU (..., M, N) with the areas *not* clamped
    (:func:`box_iou` clamps them, as the NMS kernel does); the two differ
    only for inverted boxes."""
    a = a[..., :, None, :]
    b = b[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter + EPS)


def xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], dim=-1)


def xywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = boxes.unbind(-1)
    hw, hh = w * 0.5, h * 0.5
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)
