"""SSD multibox loss: matched default boxes' smooth-L1 plus cross-entropy
with 3:1 hard-negative mining.

The port's copy of the JAX package's ``train/ssd_loss.py``, as a
fixed-shape torch program: default boxes match the padded ground truth at
IoU >= 0.5, and every ground-truth box claims its best default box; offsets
are encoded with variances (0.1, 0.2); smooth-L1 on the positives;
cross-entropy on the positives and, per image, the ``3 * positives``
hardest negatives, ranked by two stable argsorts with -inf at the
positives; both terms divided by the positive count.  Where JAX's choice
has a tie rule the port keeps it: ``argmax`` takes the first maximum, the
argsorts are stable, and a scatter of the forced matches writes the last
of equal indices (a ground-truth box later in the list wins a default box
two boxes claim, as XLA's scatter applies its updates in order).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from litepi_tpu_torch.ops.boxes import box_iou_signed, xyxy_to_xywh


def encode_boxes(
    gt_xyxy: torch.Tensor,
    defaults_cxcywh: torch.Tensor,
    variances: Tuple[float, float] = (0.1, 0.2),
) -> torch.Tensor:
    """xyxy ground truth (..., N, 4) as SSD offsets on the default boxes."""
    g = xyxy_to_xywh(gt_xyxy)
    d_cx, d_cy, d_w, d_h = (defaults_cxcywh[..., i] for i in range(4))
    t_cx = (g[..., 0] - d_cx) / (d_w * variances[0])
    t_cy = (g[..., 1] - d_cy) / (d_h * variances[0])
    t_w = torch.log(torch.clamp(g[..., 2], min=1e-6) / d_w) / variances[1]
    t_h = torch.log(torch.clamp(g[..., 3], min=1e-6) / d_h) / variances[1]
    return torch.stack([t_cx, t_cy, t_w, t_h], dim=-1)


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    a = torch.abs(x)
    return torch.where(a < 1.0, 0.5 * x * x, a - 0.5)


def force_best_matches(iou: torch.Tensor, gt_mask: torch.Tensor):
    """Every valid ground-truth box claims its best box: (forced (B, N)
    bool, forced_gt (B, N) int64), as JAX's two ``.at[...].set`` scatters
    write them: one write per ground-truth box in order, the last write to
    a box winning, and a masked-off box (IoU -1 everywhere, so its argmax
    0) writing False / 0."""
    b, g = gt_mask.shape
    best = iou.argmax(dim=2)  # (B, G), the first maximum
    order = torch.arange(g, device=iou.device).expand(b, g)
    last = torch.full(iou.shape[::2], -1, dtype=torch.long, device=iou.device)
    last.scatter_reduce_(1, best, order, "amax")
    has = last >= 0
    writer = torch.clamp(last, min=0)
    forced = has & torch.gather(gt_mask, 1, writer)
    return forced, torch.where(forced, writer, 0)


def multibox_loss(
    out: Dict[str, torch.Tensor],
    default_boxes_xyxy: torch.Tensor,
    default_boxes_cxcywh: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    iou_threshold: float = 0.5,
    neg_pos_ratio: int = 3,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(loss, {"loss_loc", "loss_cls", "num_pos"})`` for ``out`` (``loc``
    (B, N, 4), ``conf`` (B, N, C + 1)) against padded ground truth: boxes
    (B, G, 4) xyxy, foreground labels (B, G) in [0, C), mask (B, G)."""
    loc, conf = out["loc"], out["conf"]
    n = conf.shape[1]
    iou = box_iou_signed(gt_boxes, default_boxes_xyxy[None])  # (B, G, N)
    iou = torch.where(gt_mask[..., None], iou, -1.0)
    best_gt_iou = iou.amax(dim=1)
    best_gt_idx = iou.argmax(dim=1)
    forced, forced_gt = force_best_matches(iou, gt_mask)
    positive = (best_gt_iou >= iou_threshold) | forced
    assigned = torch.where(forced, forced_gt, best_gt_idx)

    tgt_boxes = torch.gather(gt_boxes, 1, assigned[..., None].expand(-1, -1, 4))
    tgt_labels = torch.gather(gt_labels.long(), 1, assigned) + 1  # background 0
    tgt_labels = torch.where(positive, tgt_labels, 0)

    enc = encode_boxes(tgt_boxes, default_boxes_cxcywh)
    loc_l = smooth_l1(loc - enc).sum(-1)
    num_pos = torch.clamp(positive.sum(), min=1)
    loss_loc = torch.where(positive, loc_l, 0.0).sum() / num_pos

    logp = torch.log_softmax(conf, dim=-1)
    ce = -torch.gather(logp, -1, tgt_labels[..., None])[..., 0]
    neg_ce = torch.where(positive, float("-inf"), ce.detach())
    order = torch.sort(-neg_ce, dim=1, stable=True)[1]
    rank = torch.sort(order, dim=1, stable=True)[1]
    num_pos_img = positive.sum(dim=1, keepdim=True)
    num_neg_img = torch.minimum(neg_pos_ratio * num_pos_img, n - num_pos_img)
    hard_neg = (rank < num_neg_img) & ~positive
    loss_cls = torch.where(positive | hard_neg, ce, 0.0).sum() / num_pos
    return loss_loc + loss_cls, {"loss_loc": loss_loc, "loss_cls": loss_cls,
                                 "num_pos": positive.sum()}
