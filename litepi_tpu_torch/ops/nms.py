"""Non-maximum suppression over a fixed, score-sorted candidate budget.

The reference runs exact greedy per-class NMS in numpy (descending stable
score order, IoU denominator + 1e-6).  :func:`nms_sorted` keeps those
semantics on static shapes: a keep mask over the K score-descending
candidates, then the survivors compacted into ``max_detections`` padded
slots.

The keep mask is the NMS kernel (``csrc/nms.cu``) for CUDA tensors and
:func:`suppress_sorted`, its plain version, for CPU tensors.
:func:`nms_numpy_reference` is the golden oracle the tests use.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from litepi_tpu_torch.ops.boxes import box_iou
from litepi_tpu_torch.ops.dfl import topk_stable


def nms_numpy_reference(
    boxes: np.ndarray, scores: np.ndarray, iou_threshold: float
) -> np.ndarray:
    """Exact greedy NMS oracle: descending score order via
    ``argsort()[::-1]``, O(n^2) suppression, IoU epsilon 1e-6.  Returns the
    kept indices."""
    if boxes.size == 0:
        return np.zeros((0,), dtype=np.int64)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        rest = order[1:]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        iou = inter / (areas[i] + areas[rest] - inter + 1e-6)
        order = rest[iou <= iou_threshold]
    return np.asarray(keep, dtype=np.int64)


def suppress_sorted(
    cand_boxes: torch.Tensor,
    cand_valid: torch.Tensor,
    cand_cls: torch.Tensor,
    iou_threshold: float,
) -> torch.Tensor:
    """Plain version of the NMS kernel: the exact greedy keep mask (..., K)
    over score-descending candidates (..., K, 4).

    Iterates ``keep[i] <- valid[i] and no kept j < i of the same class with
    IoU(j, i) > thr`` to its fixpoint, which is the greedy result; it
    converges in as many rounds as the longest suppression chain.
    """
    k = cand_boxes.shape[-2]
    iou = box_iou(cand_boxes, cand_boxes)
    same_cls = cand_cls[..., :, None] == cand_cls[..., None, :]
    ar = torch.arange(k, device=cand_boxes.device)
    j_lt_i = ar[:, None] < ar[None, :]  # [j, i]: j outranks i
    over = (iou > iou_threshold) & same_cls & j_lt_i
    keep = cand_valid
    for _ in range(k):
        suppressed = torch.any(over & keep[..., :, None], dim=-2)
        new = cand_valid & ~suppressed
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def suppress(
    cand_boxes: torch.Tensor,
    cand_valid: torch.Tensor,
    cand_cls: torch.Tensor,
    iou_threshold: float,
) -> torch.Tensor:
    """Greedy keep mask (B, K): the NMS kernel on a CUDA tensor, the plain
    :func:`suppress_sorted` on a CPU tensor."""
    if cand_boxes.is_cuda:
        from litepi_tpu_torch.kernels.nms import nms_suppress_cuda

        return nms_suppress_cuda(
            cand_boxes, cand_cls.to(torch.int32), cand_valid, iou_threshold
        )
    if cand_boxes.device.type != "cpu":
        raise ValueError(f"no NMS for device {cand_boxes.device}")
    return suppress_sorted(cand_boxes, cand_valid, cand_cls, iou_threshold)


def nms_sorted(
    cand_boxes: torch.Tensor,
    cand_scores: torch.Tensor,
    cand_cls: torch.Tensor,
    conf_threshold: float,
    iou_threshold: float,
    max_detections: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """NMS over already score-descending candidates (B, K, 4).

    Returns ``(boxes (B, D, 4), scores (B, D), class_ids (B, D) int32,
    valid (B, D) bool)`` with D = ``max_detections``, score-descending;
    invalid slots hold zero boxes, score 0 and class -1.
    """
    cand_valid = cand_scores > conf_threshold
    keep = suppress(cand_boxes, cand_valid, cand_cls, iou_threshold)
    kept_scores = torch.where(keep, cand_scores, -1.0)
    k = cand_boxes.shape[-2]
    if max_detections > k:  # tiny candidate set: pad
        pad = max_detections - k
        kept_scores = F.pad(kept_scores, (0, pad), value=-1.0)
        cand_boxes = F.pad(cand_boxes, (0, 0, 0, pad))
        cand_cls = F.pad(cand_cls, (0, pad), value=-1)
    out_scores, sel = topk_stable(kept_scores, max_detections)
    out_valid = out_scores > conf_threshold
    out_boxes = torch.where(
        out_valid[..., None],
        torch.gather(cand_boxes, -2, sel[..., None].expand(*sel.shape, 4)),
        0.0,
    )
    out_cls = torch.where(
        out_valid, torch.gather(cand_cls, -1, sel), -1
    ).to(torch.int32)
    return out_boxes, torch.where(out_valid, out_scores, 0.0), out_cls, out_valid


def nms_fixed(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    class_ids: torch.Tensor,
    conf_threshold: float = 0.25,
    iou_threshold: float = 0.45,
    max_candidates: int = 512,
    max_detections: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-shape greedy NMS over unsorted boxes (B, A, 4) or (A, 4).

    Scores at or under ``conf_threshold`` sink to -1, the top
    ``max_candidates`` (stable, ties to the lower index) become the
    score-descending candidate set, and :func:`nms_sorted` suppresses and
    compacts them.  Returns ``(boxes (.., D, 4), scores (.., D), class_ids
    (.., D) int32, valid (.., D) bool)`` with D = ``max_detections``.
    """
    if boxes.dim() == 2:
        out = nms_fixed(
            boxes[None], scores[None], class_ids[None], conf_threshold,
            iou_threshold, max_candidates, max_detections,
        )
        return tuple(t[0] for t in out)
    k = min(max_candidates, boxes.shape[-2])
    masked = torch.where(scores > conf_threshold, scores, -1.0)
    top_scores, idx = topk_stable(masked, k)
    cand_boxes = torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))
    cand_cls = torch.gather(class_ids, -1, idx)
    return nms_sorted(
        cand_boxes.contiguous(), top_scores, cand_cls, conf_threshold,
        iou_threshold, max_detections,
    )
