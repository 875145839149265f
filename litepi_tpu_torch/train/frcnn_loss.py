"""Faster R-CNN training losses, fixed-shape.

The port's copy of the JAX package's ``train/frcnn_loss.py``:

* **RPN**: anchors matched to the ground truth at IoU >= 0.7 (plus each
  box's best anchor), negatives under 0.3; 256 anchors sampled at most
  half positive; BCE objectness and smooth-L1 on the positives' deltas.
* **ROI head**: proposals matched at IoU >= 0.5; 128 sampled at most a
  quarter positive; softmax cross-entropy over nc + 1 and smooth-L1 on the
  matched class's deltas.

The sampling keeps a fixed shape by ranking the eligible entries by
uniform draws and keeping the top k.  JAX draws them with ``jax.random``
(threefry), which torch cannot reproduce, so here the draws are an input:
:func:`frcnn_loss` takes the four (B, N) uniform tensors in JAX's order
(RPN positives, RPN negatives, ROI positives, ROI negatives) or a
``torch.Generator`` that makes them.  Gradients flow where JAX's do,
through the proposals' coordinates into the ROI targets too.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import torch

from litepi_tpu_torch.models.faster_rcnn import encode_deltas
from litepi_tpu_torch.ops.boxes import box_iou_signed
from litepi_tpu_torch.train.losses import optax_sigmoid_bce
from litepi_tpu_torch.train.ssd_loss import force_best_matches, smooth_l1

Draws = Union[Sequence[torch.Tensor], torch.Generator]


def subsample_mask(mask: torch.Tensor, k: int, u: torch.Tensor) -> torch.Tensor:
    """Keep at most ``k`` True entries of ``mask`` per row: those with the
    largest uniform draws ``u`` (same shape), at a fixed shape."""
    scores = torch.where(mask, u, -1.0)
    kth = torch.topk(scores, min(k, mask.shape[-1]), dim=-1).values[..., -1:]
    return mask & (scores >= torch.clamp(kth, min=0.0))


def match(gt_boxes, gt_mask, boxes, pos_thr: float, neg_thr: float, force_best: bool):
    """(positive, negative, assigned ground-truth index), each (B, N), of
    ``boxes`` (B, N, 4) against the padded ground truth."""
    iou = box_iou_signed(gt_boxes, boxes)  # (B, G, N)
    iou = torch.where(gt_mask[..., None], iou, -1.0)
    best_iou = iou.amax(dim=1)
    best_gt = iou.argmax(dim=1)
    pos = best_iou >= pos_thr
    if force_best:
        forced, forced_gt = force_best_matches(iou, gt_mask)
        pos = pos | forced
        best_gt = torch.where(forced, forced_gt, best_gt)
    neg = (best_iou < neg_thr) & ~pos
    return pos, neg, best_gt


def _gather_boxes(gt_boxes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(gt_boxes, 1, idx[..., None].expand(-1, -1, 4))


def rpn_loss(
    obj: torch.Tensor,
    deltas: torch.Tensor,
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    draws: Sequence[torch.Tensor],
    batch_per_image: int = 256,
    pos_fraction: float = 0.5,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """obj (B, A), deltas (B, A, 4), anchors (A, 4); ``draws`` the two (B,
    A) uniforms of the positive and negative samples."""
    b = obj.shape[0]
    anchors_b = anchors.expand(b, *anchors.shape)
    pos, neg, assigned = match(gt_boxes, gt_mask, anchors_b, 0.7, 0.3, force_best=True)
    n_pos = int(batch_per_image * pos_fraction)
    pos_s = subsample_mask(pos, n_pos, draws[0])
    neg_s = subsample_mask(neg, batch_per_image - n_pos, draws[1])
    sampled = pos_s | neg_s
    n_sampled = torch.clamp(sampled.sum(), min=1)
    bce = optax_sigmoid_bce(obj, pos_s.to(obj.dtype))
    loss_obj = torch.where(sampled, bce, 0.0).sum() / n_sampled
    enc = encode_deltas(_gather_boxes(gt_boxes, assigned), anchors_b)
    l1 = smooth_l1(deltas - enc).sum(-1)
    loss_box = torch.where(pos_s, l1, 0.0).sum() / n_sampled
    return loss_obj + loss_box, {"rpn_obj_loss": loss_obj, "rpn_box_loss": loss_box,
                                 "rpn_pos": pos_s.sum()}


def roi_head_loss(
    roi_cls: torch.Tensor,
    roi_reg: torch.Tensor,
    proposals: torch.Tensor,
    proposal_valid: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    draws: Sequence[torch.Tensor],
    batch_per_image: int = 128,
    pos_fraction: float = 0.25,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """roi_cls (B, R, nc + 1), roi_reg (B, R, nc + 1, 4), proposals (B, R,
    4), proposal_valid (B, R); ``draws`` the two (B, R) uniforms."""
    pos, neg, assigned = match(gt_boxes, gt_mask, proposals, 0.5, 0.5, force_best=False)
    pos = pos & proposal_valid
    neg = neg & proposal_valid
    n_pos = int(batch_per_image * pos_fraction)
    pos_s = subsample_mask(pos, n_pos, draws[0])
    neg_s = subsample_mask(neg, batch_per_image - n_pos, draws[1])
    sampled = pos_s | neg_s
    n_sampled = torch.clamp(sampled.sum(), min=1)

    labels = torch.gather(gt_labels.long(), 1, assigned) + 1  # background 0
    labels = torch.where(pos_s, labels, 0)
    logp = torch.log_softmax(roi_cls, dim=-1)
    ce = -torch.gather(logp, -1, labels[..., None])[..., 0]
    loss_cls = torch.where(sampled, ce, 0.0).sum() / n_sampled

    enc = encode_deltas(_gather_boxes(gt_boxes, assigned), proposals)
    reg = torch.gather(roi_reg, 2, labels[..., None, None].expand(-1, -1, 1, 4))[:, :, 0, :]
    l1 = smooth_l1(reg - enc).sum(-1)
    loss_box = torch.where(pos_s, l1, 0.0).sum() / torch.clamp(pos_s.sum(), min=1)
    return loss_cls + loss_box, {"roi_cls_loss": loss_cls, "roi_box_loss": loss_box,
                                 "roi_pos": pos_s.sum()}


def frcnn_draws(out: Dict[str, torch.Tensor], generator: torch.Generator):
    """The four uniform tensors of one loss, from ``generator`` (on the
    outputs' device): (B, A) twice for the RPN, (B, R) twice for the ROI
    head."""
    dev = out["rpn_obj"].device
    a, r = out["rpn_obj"].shape, out["proposal_valid"].shape
    return tuple(torch.rand(shape, generator=generator, device=dev) for shape in (a, a, r, r))


def frcnn_loss(
    out: Dict[str, torch.Tensor],
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    draws: Draws,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """RPN + ROI-head loss of a :class:`~litepi_tpu_torch.models.faster_rcnn.
    FasterRCNN` output dict; ``draws`` as in the module docstring."""
    if isinstance(draws, torch.Generator):
        draws = frcnn_draws(out, draws)
    l_rpn, aux1 = rpn_loss(out["rpn_obj"], out["rpn_deltas"], out["anchors"], gt_boxes,
                           gt_mask, draws[:2])
    l_roi, aux2 = roi_head_loss(out["roi_cls"], out["roi_reg"], out["proposals"],
                                out["proposal_valid"], gt_boxes, gt_labels, gt_mask, draws[2:])
    return l_rpn + l_roi, {**aux1, **aux2}
