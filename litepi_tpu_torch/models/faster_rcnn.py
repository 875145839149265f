"""Faster R-CNN (ResNet50-FPN), the reference's two-stage baseline, NCHW.

The port's copy of the JAX package's ``models/faster_rcnn.py``, on static
shapes throughout:

* ResNet-50 C2..C5 -> FPN P2..P6 (256 channels; P6 is P5 at stride 2),
* RPN: a shared 3x3 conv, 3 anchors per cell over five levels; proposals
  are the top ``pre_nms_topk`` objectness scores (ties to the lower index,
  as ``jax.lax.top_k``), decoded, clipped, freed of boxes of side <= 1 and
  suppressed at IoU 0.7 by :func:`~litepi_tpu_torch.ops.nms.suppress` —
  the NMS kernel on the card (one class, K = ``pre_nms_topk``: 1,024 by
  default, torchvision's 2,000 for training), ``suppress_sorted`` on the
  CPU, which JAX runs here
  and the kernel equals bit for bit — then the top ``post_nms_topk``
  survivors,
* RoIAlign from a zero-padded P2..P5 pyramid, one batched gather over
  every image's ROIs (JAX maps over the images): each ROI on level
  ``floor(2 + log2(sqrt(area) / 224 + 1e-9))``, 14x14 bilinear samples
  clamped into the level's real extent, averaged 2x2 to 7x7,
* box head: two Dense-1024 layers, class logits (nc + 1, background 0)
  and per-class deltas.

Outputs keep the JAX package's layouts: anchors flattened per level in
(y, x, anchor) order, ``roi_align``'s samples NHWC.  The model computes in
the dtype of its input and conv weights (``train/detector.py::forward_in``
casts both for bf16); a biased bf16 conv or Dense rounds its output before
the bias add, as flax's do (``layers.py::conv_bias_apart``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from litepi_tpu_torch.models.layers import conv_bias_apart, flatten_anchors, upsample2x_nearest
from litepi_tpu_torch.models.resnet import ResNet50Backbone
from litepi_tpu_torch.ops.boxes import clip_boxes
from litepi_tpu_torch.ops.dfl import topk_stable
from litepi_tpu_torch.ops.nms import nms_sorted, suppress

FPN_STRIDES = (4, 8, 16, 32, 64)
ANCHOR_SIZES = (32, 64, 128, 256, 512)
ANCHOR_RATIOS = (0.5, 1.0, 2.0)


def rpn_anchors(input_size: int) -> np.ndarray:
    """(A_total, 4) xyxy float32 anchors over P2..P6: per level, cells
    row-major, 3 ratios per cell."""
    blocks = []
    for stride, size in zip(FPN_STRIDES, ANCHOR_SIZES):
        n = input_size // stride
        xs = (np.arange(n, dtype=np.float32) + 0.5) * stride
        cx, cy = np.meshgrid(xs, xs)
        cx, cy = cx.reshape(-1), cy.reshape(-1)
        per_ratio = []
        for r in ANCHOR_RATIOS:
            w = size * np.sqrt(1.0 / r)
            h = size * np.sqrt(r)
            per_ratio.append(np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1))
        blocks.append(np.stack(per_ratio, axis=1).reshape(-1, 4))
    return np.concatenate(blocks).astype(np.float32)


def decode_deltas(deltas: torch.Tensor, boxes: torch.Tensor, clip: float = 4.135) -> torch.Tensor:
    """(dx, dy, dw, dh) deltas applied to xyxy boxes -> xyxy."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + w / 2
    cy = boxes[..., 1] + h / 2
    ncx = deltas[..., 0] * w + cx
    ncy = deltas[..., 1] * h + cy
    nw = torch.exp(torch.clamp(deltas[..., 2], -clip, clip)) * w
    nh = torch.exp(torch.clamp(deltas[..., 3], -clip, clip)) * h
    return torch.stack([ncx - nw / 2, ncy - nh / 2, ncx + nw / 2, ncy + nh / 2], dim=-1)


def _floor_at(x: torch.Tensor, v: float) -> torch.Tensor:
    """``jnp.maximum(x, v)`` (its gradient split at a tie, as JAX's)."""
    return torch.maximum(x, torch.full_like(x, v))


def encode_deltas(gt: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """xyxy ``gt`` relative to xyxy ``anchors`` -> (dx, dy, dw, dh)."""
    aw = _floor_at(anchors[..., 2] - anchors[..., 0], 1e-3)
    ah = _floor_at(anchors[..., 3] - anchors[..., 1], 1e-3)
    acx = anchors[..., 0] + aw / 2
    acy = anchors[..., 1] + ah / 2
    gw = _floor_at(gt[..., 2] - gt[..., 0], 1e-3)
    gh = _floor_at(gt[..., 3] - gt[..., 1], 1e-3)
    gcx = gt[..., 0] + gw / 2
    gcy = gt[..., 1] + gh / 2
    return torch.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                        torch.log(gw / aw), torch.log(gh / ah)], dim=-1)


class FPN(nn.Module):
    """1x1 laterals on C2..C5, top-down nearest 2x sums, 3x3 ``post``
    convs, and P6 = P5 at stride 2 (flax's 1x1 max-pool of stride 2)."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256) -> None:
        super().__init__()
        for i, c in enumerate(in_channels):
            setattr(self, f"lateral{i}", nn.Conv2d(c, out_channels, 1))
            setattr(self, f"post{i}", nn.Conv2d(out_channels, out_channels, 3, 1, 1))
        self.n = len(in_channels)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [conv_bias_apart(getattr(self, f"lateral{i}"), f) for i, f in enumerate(feats)]
        outs = [laterals[-1]]
        for lat in laterals[-2::-1]:
            outs.insert(0, lat + upsample2x_nearest(outs[0]))
        outs = [conv_bias_apart(getattr(self, f"post{i}"), o) for i, o in enumerate(outs)]
        outs.append(outs[-1][:, :, ::2, ::2])
        return outs


class RPNHead(nn.Module):
    """A 3x3 conv + ReLU shared over the levels, 1x1 objectness and box
    heads; returns (objectness (B, A) float32, deltas (B, A, 4) float32)."""

    def __init__(self, channels: int = 256, num_anchors: int = 3) -> None:
        super().__init__()
        self.conv = nn.Conv2d(channels, 256, 3, 1, 1)
        self.obj = nn.Conv2d(256, num_anchors, 1)
        self.box = nn.Conv2d(256, num_anchors * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        objs, boxes = [], []
        for f in feats:
            t = F.relu(conv_bias_apart(self.conv, f))
            b = t.shape[0]
            objs.append(flatten_anchors(conv_bias_apart(self.obj, t)).reshape(b, -1))
            boxes.append(flatten_anchors(conv_bias_apart(self.box, t)).reshape(b, -1, 4))
        return torch.cat(objs, 1).float(), torch.cat(boxes, 1).float()


def roi_align(
    pyramid: torch.Tensor,
    rois: torch.Tensor,
    valid: torch.Tensor,
    out_size: int = 7,
    sampling: int = 2,
) -> torch.Tensor:
    """FPN RoIAlign over every image at once.

    pyramid (B, L, Hmax, Wmax, C): zero-padded levels P2..P5, each in the
    top-left corner of its slot; rois (B, R, 4) xyxy input pixels; valid
    (B, R).  Returns (B, R, out_size, out_size, C) float32: per ROI its
    level, ``sampling^2`` bilinear samples per bin (feature-pixel centres
    at integer coordinates, samples clamped into the level's real extent)
    averaged, zero at invalid ROIs.  The JAX package's ``roi_align`` per
    image, as gathers from one flat buffer."""
    b, n_levels, hmax, wmax, c = pyramid.shape
    r = rois.shape[1]
    w = rois[..., 2] - rois[..., 0]
    h = rois[..., 3] - rois[..., 1]
    area = _floor_at(w * h, 1e-6)
    k = torch.floor(2.0 + torch.log2(torch.sqrt(area) / 224.0 + 1e-9))
    level = torch.clamp(k, 0, n_levels - 1).long()
    stride = (4.0 * torch.pow(2.0, level.float()))[..., None]  # (B, R, 1)

    s = out_size * sampling
    frac = (torch.arange(s, dtype=torch.float32, device=rois.device) + 0.5) / s
    x = rois[..., 0:1] / stride + frac * (w[..., None] / stride)  # (B, R, s)
    y = rois[..., 1:2] / stride + frac * (h[..., None] / stride)

    lv_h = (hmax / torch.pow(2.0, level.float()))[..., None]
    x = torch.minimum(torch.clamp(x, min=0.0), lv_h - 1.0)
    y = torch.minimum(torch.clamp(y, min=0.0), lv_h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    last = (lv_h - 1).long()
    x1 = torch.minimum(x0.long() + 1, last)
    y1 = torch.minimum(y0.long() + 1, last)
    fx = (x - x0)[..., None, :, None]  # (B, R, 1, s, 1)
    fy = (y - y0)[..., :, None, None]  # (B, R, s, 1, 1)
    x0, y0 = x0.long(), y0.long()

    flat = pyramid.reshape(-1, c)
    base = ((torch.arange(b, device=rois.device)[:, None] * n_levels + level) * hmax)[..., None, None]

    def gather(yi, xi):  # (B, R, s) each -> (B, R, s, s, C) float32
        idx = (base + yi[..., :, None]) * wmax + xi[..., None, :]
        return flat[idx.reshape(-1)].reshape(b, r, s, s, c).float()

    top = gather(y0, x0) * (1 - fx) + gather(y0, x1) * fx
    bot = gather(y1, x0) * (1 - fx) + gather(y1, x1) * fx
    samples = top * (1 - fy) + bot * fy
    pooled = samples.reshape(b, r, out_size, sampling, out_size, sampling, c).mean(dim=(3, 5))
    return torch.where(valid[..., None, None, None], pooled, 0.0)


def _dense_bias_apart(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer`` in ``x``'s dtype; in bf16 its product rounds before the
    bias add, as a biased bf16 flax ``nn.Dense`` rounds."""
    y = F.linear(x, layer.weight.to(x.dtype))
    return y + layer.bias.to(x.dtype)


class BoxHead(nn.Module):
    """Pooled ROIs (N, 7, 7, C) -> (class logits (N, nc + 1), deltas (N,
    nc + 1, 4)), float32.  ``fc1`` / ``fc2`` compute in ``dtype``; ``cls``
    and ``reg`` in float32, as the JAX head."""

    def __init__(self, num_classes: int, in_features: int = 7 * 7 * 256,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(in_features, 1024)
        self.fc2 = nn.Linear(1024, 1024)
        nc1 = num_classes + 1
        self.cls = nn.Linear(1024, nc1)
        self.reg = nn.Linear(1024, nc1 * 4)

    def forward(self, pooled: torch.Tensor):
        r = pooled.shape[0]
        x = pooled.reshape(r, -1).to(self.dtype)
        x = F.relu(_dense_bias_apart(self.fc1, x))
        x = F.relu(_dense_bias_apart(self.fc2, x))
        x = x.float()
        cls = F.linear(x, self.cls.weight.float(), self.cls.bias.float())
        reg = F.linear(x, self.reg.weight.float(), self.reg.bias.float())
        return cls, reg.reshape(r, cls.shape[1], 4)


class FasterRCNN(nn.Module):
    """Faster R-CNN with fixed proposal budgets.

    Input (B, 3, S, S) with S = ``input_size`` in [0, 1] RGB.  Returns the
    JAX model's dict: ``rpn_obj`` (B, A), ``rpn_deltas`` (B, A, 4),
    ``anchors`` (A, 4), ``proposals`` (B, R, 4), ``proposal_scores`` (B,
    R), ``proposal_valid`` (B, R), ``roi_cls`` (B, R, nc + 1), ``roi_reg``
    (B, R, nc + 1, 4), float32, R = ``post_nms_topk``.  ``dtype`` is the
    box head's ``fc1`` / ``fc2`` compute dtype; the convs take their
    weights' dtype."""

    def __init__(
        self,
        num_classes: int = 1,
        input_size: int = 640,
        pre_nms_topk: int = 1024,
        post_nms_topk: int = 256,
        rpn_nms_iou: float = 0.7,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.num_classes = num_classes
        self.input_size = input_size
        self.pre_nms_topk = pre_nms_topk
        self.post_nms_topk = post_nms_topk
        self.rpn_nms_iou = rpn_nms_iou
        self.dtype = dtype
        self.backbone = ResNet50Backbone()
        self.fpn = FPN()
        self.rpn = RPNHead()
        self.box_head = BoxHead(num_classes, dtype=dtype)
        self.register_buffer("anchors", torch.from_numpy(rpn_anchors(input_size)),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        b = x.shape[0]
        pyramid = self.fpn(self.backbone(x))  # P2..P6
        obj, deltas = self.rpn(pyramid)
        anchors = self.anchors.float()  # float32 in any dtype, as JAX's numpy constant

        top_obj, idx = topk_stable(obj, min(self.pre_nms_topk, obj.shape[1]))
        # the anchors with the indices clamped, as XLA's gather clamps them:
        # at an input size that is not a multiple of 64 the levels hold
        # fewer anchors (cells rounded down) than the RPN scores (P6's conv
        # rounds up), and JAX's ``anchors[idx]`` gives the last anchor
        cand = decode_deltas(torch.gather(deltas, 1, idx[..., None].expand(-1, -1, 4)),
                             anchors[idx.clamp(0, anchors.shape[0] - 1)])
        cand = clip_boxes(cand, self.input_size, self.input_size)
        ok = (cand[..., 2] - cand[..., 0] > 1) & (cand[..., 3] - cand[..., 1] > 1)
        keep = suppress(cand.detach().float().contiguous(), ok,
                        torch.zeros(ok.shape, dtype=torch.int32, device=ok.device),
                        self.rpn_nms_iou)
        kept_scores = torch.where(keep, top_obj, float("-inf"))
        p_scores, sel = topk_stable(kept_scores, self.post_nms_topk)
        proposals = torch.gather(cand, 1, sel[..., None].expand(-1, -1, 4))
        p_valid = torch.isfinite(p_scores)
        proposals = torch.where(p_valid[..., None], proposals, 0.0)

        # RoIAlign from a zero-padded P2..P5 pyramid, NHWC as JAX's
        hmax = pyramid[0].shape[2]
        padded = torch.stack(
            [F.pad(p, (0, hmax - p.shape[3], 0, hmax - p.shape[2])).permute(0, 2, 3, 1)
             for p in pyramid[:4]], dim=1)
        pooled = roi_align(padded, proposals, p_valid)
        r = self.post_nms_topk
        cls, reg = self.box_head(pooled.reshape(b * r, *pooled.shape[2:]))
        return {
            "rpn_obj": obj,
            "rpn_deltas": deltas,
            "anchors": anchors,
            "proposals": proposals,
            "proposal_scores": torch.where(p_valid, p_scores, 0.0),
            "proposal_valid": p_valid,
            "roi_cls": cls.reshape(b, r, -1),
            "roi_reg": reg.reshape(b, r, self.num_classes + 1, 4),
        }


def postprocess_detections(
    out: Dict[str, torch.Tensor],
    input_size: int,
    conf_threshold: float = 0.05,
    iou_threshold: float = 0.5,
    max_detections: int = 64,
):
    """Final detections from the box head: softmax scores without the
    background, the argmax class's deltas decoded on the proposals and
    clipped, a stable score-descending order, then class-aware
    :func:`~litepi_tpu_torch.ops.nms.nms_sorted` (the NMS kernel on the
    card at K = R).  Returns (boxes, scores, class_ids, valid) with
    ``max_detections`` slots."""
    probs = torch.softmax(out["roi_cls"], dim=-1)[..., 1:]
    scores = probs.amax(-1)
    labels = probs.argmax(-1).to(torch.int32)  # the first maximum, as jnp.argmax
    reg = torch.gather(out["roi_reg"], 2,
                       (labels.long() + 1)[..., None, None].expand(-1, -1, 1, 4))[:, :, 0, :]
    boxes = clip_boxes(decode_deltas(reg, out["proposals"]), input_size, input_size)
    scores = torch.where(out["proposal_valid"], scores, 0.0)
    order = torch.sort(-scores, dim=-1, stable=True)[1]
    boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    scores = torch.gather(scores, 1, order)
    labels = torch.gather(labels, 1, order)
    return nms_sorted(boxes.contiguous(), scores, labels, conf_threshold, iou_threshold,
                      max_detections)
