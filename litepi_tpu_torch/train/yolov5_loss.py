"""Training loss of the anchor-based YOLOv5n, fixed-shape.

The port's copy of the JAX package's ``train/yolov5_loss.py`` (the
Ultralytics v5 recipe):

* **targets**: a ground-truth box matches a prior when max(r, 1/r) < 4
  with r = box wh / prior wh, at its own cell and the two neighbour cells
  nearer its centre (v5's 0.5-offset rule): a dense (B, G, 3 levels x 3
  priors x 3 cells) candidate tensor with a validity mask;
* **box**: 1 - CIoU between the v5-decoded prediction at each matched slot
  and its box, averaged over the matches;
* **objectness**: BCE over every anchor, the positives' target the
  detached CIoU (the largest where slots share an anchor), per-level
  balance (4.0, 1.0, 0.4);
* **cls**: BCE at the matched slots (nc > 1 only);
* gains box 0.05, obj 1.0, cls 0.5, the sum times the batch size.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from litepi_tpu_torch.models.yolov5 import V5_ANCHORS
from litepi_tpu_torch.train.losses import optax_sigmoid_bce, pairwise_iou_ciou

LEVEL_BALANCE = (4.0, 1.0, 0.4)


def level_tables(input_size: int, strides=(8, 16, 32), anchors=V5_ANCHORS):
    """Per level: stride, grid size, flat offset and prior wh; and the
    total prediction count."""
    tables, offset = [], 0
    for s, priors in zip(strides, anchors):
        n = input_size // s
        tables.append({"stride": s, "n": n, "offset": offset,
                       "priors": np.asarray(priors, np.float32)})
        offset += n * n * 3
    return tables, offset


def build_targets(
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    input_size: int,
    anchor_t: float = 4.0,
) -> Dict[str, torch.Tensor]:
    """Dense candidate targets, each (B, G, C, ...) with C = 27: flat
    prediction ``index``, ``valid``, target xy relative to the assigned
    cell ``txy``, target wh in pixels ``twh``, ``prior`` wh, ``stride``,
    ``level`` and ``label``."""
    tables, _ = level_tables(input_size)
    b, g = gt_mask.shape
    dev = gt_boxes.device
    cx = (gt_boxes[..., 0] + gt_boxes[..., 2]) * 0.5
    cy = (gt_boxes[..., 1] + gt_boxes[..., 3]) * 0.5
    w = gt_boxes[..., 2] - gt_boxes[..., 0]
    h = gt_boxes[..., 3] - gt_boxes[..., 1]
    parts = {k: [] for k in ("index", "valid", "txy", "twh", "prior", "stride", "level")}
    for li, t in enumerate(tables):
        s, n, off = t["stride"], t["n"], t["offset"]
        gx, gy = cx / s, cy / s
        cell_x, cell_y = torch.floor(gx), torch.floor(gy)
        fx, fy = gx - cell_x, gy - cell_y
        nbr_dx = torch.where(fx < 0.5, -1.0, 1.0)
        nbr_dy = torch.where(fy < 0.5, -1.0, 1.0)
        zero = torch.zeros_like(fx)
        cells = ((zero, zero), (nbr_dx, zero), (zero, nbr_dy))
        for pi in range(3):
            pw, ph = (float(v) for v in t["priors"][pi])
            r_w, r_h = w / pw, h / ph
            ratio_ok = torch.maximum(
                torch.maximum(r_w, 1.0 / torch.clamp(r_w, min=1e-9)),
                torch.maximum(r_h, 1.0 / torch.clamp(r_h, min=1e-9)),
            ) < anchor_t
            for dx, dy in cells:
                ccx, ccy = cell_x + dx, cell_y + dy
                inside = (ccx >= 0) & (ccx < n) & (ccy >= 0) & (ccy < n)
                ok = gt_mask & ratio_ok & inside
                flat = off + (ccy * n + ccx) * 3 + pi
                parts["index"].append(torch.where(ok, flat, 0.0).long())
                parts["valid"].append(ok)
                parts["txy"].append(torch.stack([gx - ccx, gy - ccy], dim=-1))
                parts["twh"].append(torch.stack([w, h], dim=-1))
                parts["prior"].append(torch.tensor([pw, ph], device=dev).expand(b, g, 2))
                parts["stride"].append(torch.full((b, g), float(s), device=dev))
                parts["level"].append(torch.full((b, g), li, dtype=torch.long, device=dev))
    out = {k: torch.stack(v, dim=2) for k, v in parts.items()}
    out["label"] = gt_labels.long()[:, :, None].expand_as(out["valid"])
    return out


def yolov5_loss(
    pred: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    input_size: int,
    w_box: float = 0.05,
    w_obj: float = 1.0,
    w_cls: float = 0.5,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(loss, {"loss_box", "loss_obj", "loss_cls", "num_matched"})`` of
    the raw head output ``pred`` (B, A, 5 + nc) against padded ground
    truth (boxes (B, G, 4) xyxy pixels, labels, mask)."""
    b, a, no = pred.shape
    nc = no - 5
    tgt = build_targets(gt_boxes, gt_labels, gt_mask, input_size)
    idx = tgt["index"].reshape(b, -1)
    valid = tgt["valid"].reshape(b, -1)
    t = idx.shape[1]

    p = torch.gather(pred, 1, idx[..., None].expand(-1, -1, no))
    sig = torch.sigmoid(p)
    pred_xy = 2.0 * sig[..., 0:2] - 0.5
    prior = tgt["prior"].reshape(b, t, 2)
    stride = tgt["stride"].reshape(b, t)[..., None]
    pred_wh = (2.0 * sig[..., 2:4]) ** 2 * prior
    txy = tgt["txy"].reshape(b, t, 2)
    twh = tgt["twh"].reshape(b, t, 2)
    pb = torch.cat([pred_xy * stride - pred_wh / 2, pred_xy * stride + pred_wh / 2], -1)
    gb = torch.cat([txy * stride - twh / 2, txy * stride + twh / 2], -1)
    _, ciou = pairwise_iou_ciou(gb[:, :, None, :], pb[:, :, None, :])
    ciou = ciou[..., 0, 0]
    n_pos = torch.clamp(valid.sum(), min=1)
    loss_box = torch.where(valid, 1.0 - ciou, 0.0).sum() / n_pos

    iou_d = torch.clamp(ciou.detach(), 0.0, 1.0)
    obj_tgt = torch.zeros((b, a), dtype=pred.dtype, device=pred.device)
    obj_tgt.scatter_reduce_(1, idx, torch.where(valid, iou_d, 0.0), "amax")
    obj_bce = optax_sigmoid_bce(pred[..., 4], obj_tgt)
    tables, total = level_tables(input_size)
    balance = np.zeros(total, np.float32)
    for tab, bal in zip(tables, LEVEL_BALANCE):
        balance[tab["offset"]: tab["offset"] + tab["n"] ** 2 * 3] = bal
    loss_obj = (obj_bce * torch.from_numpy(balance).to(pred.device)[None]).mean()

    if nc > 1:
        labels = tgt["label"].reshape(b, t)
        onehot = (labels[..., None] == torch.arange(nc, device=pred.device)).to(pred.dtype)
        cls_bce = optax_sigmoid_bce(p[..., 5:], onehot).sum(-1)
        loss_cls = torch.where(valid, cls_bce, 0.0).sum() / n_pos
    else:
        loss_cls = torch.zeros((), dtype=pred.dtype, device=pred.device)

    total_loss = (w_box * loss_box + w_obj * loss_obj + w_cls * loss_cls) * b
    return total_loss, {"loss_box": loss_box, "loss_obj": loss_obj, "loss_cls": loss_cls,
                        "num_matched": valid.sum()}
