"""Detection loss: task-aligned assignment + CIoU + DFL + BCE.

The port's copy of the JAX package's ``litepi_tpu/train/losses.py``, in
stock torch ops: the reference's Ultralytics v8DetectionLoss as a dense,
fixed-shape program (ground truth padded to ``max_gt`` boxes with a mask,
the assignment a (B, G, A) tensor program).  Defaults are Ultralytics':
top-k 10, alpha 0.5, beta 6.0, loss weights box 7.5 / cls 0.5 / dfl 1.5.

Autograd sees what ``jax.grad`` sees: the assigner takes the predicted
boxes detached (JAX's ``stop_gradient``) but the class probabilities live,
so the aligned target scores carry gradient, as in the JAX loss.  Where
JAX's choice has a tie rule the port keeps it: top-k keeps every anchor
whose metric reaches the k-th largest (``align >= kth``), ``argmax`` takes
the first maximum, and a maximum against 0 splits its gradient at a tie
(``torch.maximum``, not ``clamp``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from litepi_tpu_torch.ops.boxes import EPS
from litepi_tpu_torch.ops.dfl import dfl_decode


def _relu0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0.0)``, its gradient halved at x == 0 as JAX's."""
    return torch.maximum(x, torch.zeros_like(x))


def _floor_at(x: torch.Tensor, v: float) -> torch.Tensor:
    """``jnp.maximum(x, v)``."""
    return torch.maximum(x, torch.full_like(x, v))


def pairwise_iou_ciou(
    gt: torch.Tensor, pred: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IoU and CIoU between gt (..., G, 4) and pred (..., A, 4) -> (..., G, A).

    CIoU = IoU - center_dist^2 / diag^2 - alpha * v, with v the aspect-ratio
    consistency term and alpha detached."""
    g = gt[..., :, None, :]
    p = pred[..., None, :, :]
    lt = torch.maximum(g[..., :2], p[..., :2])
    rb = torch.minimum(g[..., 2:], p[..., 2:])
    wh = _relu0(rb - lt)
    inter = wh[..., 0] * wh[..., 1]
    area_g = _relu0(g[..., 2] - g[..., 0]) * _relu0(g[..., 3] - g[..., 1])
    area_p = _relu0(p[..., 2] - p[..., 0]) * _relu0(p[..., 3] - p[..., 1])
    union = area_g + area_p - inter + EPS
    iou = inter / union

    # enclosing box diagonal
    c_lt = torch.minimum(g[..., :2], p[..., :2])
    c_rb = torch.maximum(g[..., 2:], p[..., 2:])
    c_wh = c_rb - c_lt
    c2 = c_wh[..., 0] ** 2 + c_wh[..., 1] ** 2 + EPS
    # center distance
    g_c = (g[..., :2] + g[..., 2:]) * 0.5
    p_c = (p[..., :2] + p[..., 2:]) * 0.5
    rho2 = torch.sum((g_c - p_c) ** 2, dim=-1)

    g_w = _floor_at(g[..., 2] - g[..., 0], EPS)
    g_h = _floor_at(g[..., 3] - g[..., 1], EPS)
    p_w = _floor_at(p[..., 2] - p[..., 0], EPS)
    p_h = _floor_at(p[..., 3] - p[..., 1], EPS)
    v = (4 / math.pi**2) * (torch.atan(g_w / g_h) - torch.atan(p_w / p_h)) ** 2
    alpha = (v / (v - iou + (1 + EPS))).detach()
    ciou = iou - rho2 / c2 - alpha * v
    return iou, ciou


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take_along_axis(x, idx[:, None, :], axis=1)[:, 0]``: x (B, G, A),
    idx (B, A) -> (B, A)."""
    return torch.gather(x, 1, idx[:, None, :])[:, 0]


def task_aligned_assign(
    pred_scores: torch.Tensor,  # (B, A, nc) sigmoid probabilities
    pred_boxes: torch.Tensor,  # (B, A, 4) xyxy, pixel space
    anchor_centers: torch.Tensor,  # (A, 2) pixel space
    gt_boxes: torch.Tensor,  # (B, G, 4) xyxy pixel space, padded
    gt_labels: torch.Tensor,  # (B, G) integer
    gt_mask: torch.Tensor,  # (B, G) bool
    topk: int = 10,
    alpha: float = 0.5,
    beta: float = 6.0,
) -> Dict[str, torch.Tensor]:
    """Dense task-aligned assigner.

    Returns per-anchor targets: ``fg`` (B, A) bool, ``target_boxes`` (B, A, 4),
    ``target_labels`` (B, A), ``target_scores`` (B, A) (the normalised
    alignment score weighting both cls and box losses), ``target_iou``."""
    B, A, nc = pred_scores.shape
    gt_labels = gt_labels.long()

    iou, _ = pairwise_iou_ciou(gt_boxes, pred_boxes)  # (B, G, A)
    iou = torch.clamp(iou, 0.0, 1.0)

    # classification score of each anchor for each gt's class
    labels = torch.clamp(gt_labels, 0, nc - 1)
    cls_score = torch.gather(
        pred_scores.transpose(1, 2), 1, labels[..., None].expand(-1, -1, A)
    )  # (B, G, A)

    align = (cls_score**alpha) * (iou**beta)

    # candidates: anchor centre strictly inside the gt box
    cx = anchor_centers[None, None, :, 0]
    cy = anchor_centers[None, None, :, 1]
    inside = (
        (cx > gt_boxes[..., 0:1])
        & (cx < gt_boxes[..., 2:3])
        & (cy > gt_boxes[..., 1:2])
        & (cy < gt_boxes[..., 3:4])
    )  # (B, G, A)
    candidate = inside & gt_mask[..., None]
    align = torch.where(candidate, align, torch.zeros_like(align))

    # top-k per gt: keep anchors whose metric reaches the k-th largest
    # (align > 0 excludes non-candidates when fewer than k exist)
    kth = torch.topk(align.detach(), topk, dim=-1).values[..., -1:]  # (B, G, 1)
    pos = candidate & (align >= kth) & (align > 0)

    # conflict resolution: an anchor claimed by several gts goes to the
    # max-IoU gt (the first of equal ones, as JAX's argmax)
    claimed_iou = torch.where(pos, iou, torch.full_like(iou, -1.0))
    assigned_gt = torch.argmax(claimed_iou, dim=1)  # (B, A)
    fg = pos.any(dim=1)  # (B, A)

    tgt_iou = _take(iou, assigned_gt)
    tgt_align = _take(align, assigned_gt)
    tgt_boxes = torch.gather(
        gt_boxes, 1, assigned_gt[..., None].expand(-1, -1, 4)
    )  # (B, A, 4)
    tgt_labels = torch.gather(gt_labels, 1, assigned_gt)  # (B, A)

    # normalise: score = align / max_align_per_gt * max_iou_per_gt
    zeros = torch.zeros_like(align)
    max_align = torch.amax(torch.where(pos, align, zeros), dim=-1)  # (B, G)
    max_iou = torch.amax(torch.where(pos, iou, zeros), dim=-1)  # (B, G)
    norm = max_iou / (max_align + EPS)  # (B, G)
    norm_per_anchor = torch.gather(norm, 1, assigned_gt)  # (B, A)
    target_scores = torch.where(fg, tgt_align * norm_per_anchor, torch.zeros_like(tgt_align))

    return {
        "fg": fg,
        "target_boxes": tgt_boxes,
        "target_labels": torch.where(fg, tgt_labels, torch.zeros_like(tgt_labels)),
        "target_scores": target_scores,
        "target_iou": tgt_iou,
    }


def dfl_loss(
    reg_logits: torch.Tensor,  # (B, A, 4*reg_max)
    target_dist: torch.Tensor,  # (B, A, 4) distances in grid units
    reg_max: int,
) -> torch.Tensor:
    """Distribution focal loss: soft cross-entropy against the two integer
    bins bracketing each target distance.  Returns (B, A) per-anchor loss
    (mean over the 4 sides)."""
    t = torch.clamp(target_dist, 0.0, reg_max - 1.01)
    tl = torch.floor(t)
    tr = tl + 1.0
    wl = tr - t
    wr = t - tl
    logits = reg_logits.reshape(*reg_logits.shape[:-1], 4, reg_max)
    logp = F.log_softmax(logits, dim=-1)
    l_tl = torch.gather(logp, -1, tl.long()[..., None])[..., 0]
    l_tr = torch.gather(logp, -1, tr.long()[..., None])[..., 0]
    return -(wl * l_tl + wr * l_tr).mean(dim=-1)


def detection_loss(
    out: Dict[str, torch.Tensor],  # model output: reg (B,A,4R), cls (B,A,nc)
    anchors: torch.Tensor,  # (A, 2) cell units
    strides: torch.Tensor,  # (A, 1)
    gt_boxes: torch.Tensor,  # (B, G, 4) xyxy pixel space, padded
    gt_labels: torch.Tensor,  # (B, G)
    gt_mask: torch.Tensor,  # (B, G)
    reg_max: int = 16,
    w_box: float = 7.5,
    w_cls: float = 0.5,
    w_dfl: float = 1.5,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full detection loss in float32.  Returns (scalar loss, aux dict)."""
    reg_logits = out["reg"].float()
    cls_logits = out["cls"].float()
    B, A, nc = cls_logits.shape

    dist = dfl_decode(reg_logits, reg_max)  # (B, A, 4) grid units
    centers_px = anchors * strides  # (A, 2)
    lt = (anchors - dist[..., :2]) * strides
    rb = (anchors + dist[..., 2:]) * strides
    pred_boxes = torch.cat([lt, rb], dim=-1)  # (B, A, 4) pixels

    probs = torch.sigmoid(cls_logits)
    assign = task_aligned_assign(
        probs, pred_boxes.detach(), centers_px, gt_boxes, gt_labels, gt_mask,
    )
    fg = assign["fg"]
    tscores = assign["target_scores"]
    tsum = _floor_at(tscores.sum(), 1.0)
    zero = torch.zeros_like(tscores)

    # classification: BCE against the aligned soft targets over all anchors
    onehot = F.one_hot(assign["target_labels"], nc).to(cls_logits.dtype)
    cls_target = onehot * tscores[..., None]
    bce = optax_sigmoid_bce(cls_logits, cls_target)
    loss_cls = bce.sum() / tsum

    # box: CIoU on foreground anchors, weighted by the aligned score
    _, ciou = pairwise_iou_ciou(
        assign["target_boxes"][:, :, None, :], pred_boxes[:, :, None, :]
    )
    ciou = ciou[..., 0, 0]  # (B, A): paired, not cross
    loss_box = torch.where(fg, (1.0 - ciou) * tscores, zero).sum() / tsum

    # dfl: distances from anchor centre to target box edges, grid units
    tb = assign["target_boxes"] / strides
    a = anchors[None]
    tdist = torch.cat([a - tb[..., :2], tb[..., 2:] - a], dim=-1)  # (l, t, r, b)
    per_anchor_dfl = dfl_loss(reg_logits, tdist, reg_max)
    loss_dfl = torch.where(fg, per_anchor_dfl * tscores, zero).sum() / tsum

    total = w_box * loss_box + w_cls * loss_cls + w_dfl * loss_dfl
    aux = {
        "loss_box": loss_box,
        "loss_cls": loss_cls,
        "loss_dfl": loss_dfl,
        "num_fg": fg.sum(),
    }
    return total, aux


def optax_sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise binary cross-entropy with logits,
    written as the JAX loss writes it."""
    return _relu0(logits) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))
