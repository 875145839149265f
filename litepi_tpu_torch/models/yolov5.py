"""The YOLOv5n detector in both head forms, its anchor table and decoders,
NCHW.

Mirrors the JAX package's ``models/yolov5.py`` (Flax submodule names kept:
``stem``, ``c3_1.m0.cv1``, ``td_cv5``, ``reg0_cv1``, ``head0``, ...).
``anchor_free=True`` is the u-variant the reference deployed: the v8 DFL
head with YoloLitePi's ``{reg, cls}`` contract, in the model's dtype.
``anchor_free=False`` is the classic 3-prior head: ``{pred}`` (B, A, 5 +
nc) float32, anchor-major within each cell, whose candidates come from
:func:`v5_candidates` (the pipeline's ``candidate_decoder``, see
:class:`V5CandidateDecoder`).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from litepi_tpu_torch.core.device import resolve_device
from litepi_tpu_torch.core.types import make_divisible, scale_depth
from litepi_tpu_torch.models.layers import SPPF, ConvBN, flatten_anchors, upsample2x_nearest
from litepi_tpu_torch.ops.act import sigmoid, silu
from litepi_tpu_torch.ops.dfl import topk_stable

# COCO-default v5 anchor priors, per level P3/P4/P5, in input pixels
V5_ANCHORS: Tuple[Tuple[Tuple[float, float], ...], ...] = (
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)


class BottleneckV5(nn.Module):
    """C3's inner block: 1x1 then 3x3 at full width, residual."""

    def __init__(self, c: int, shortcut: bool = True) -> None:
        super().__init__()
        self.cv1 = ConvBN(c, c, 1)
        self.cv2 = ConvBN(c, c, 3)
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C3(nn.Module):
    """v5's CSP block: two parallel 1x1 projections, one through ``n``
    bottlenecks, concat, 1x1 fuse."""

    def __init__(self, c_in: int, c_out: int, n: int = 1, shortcut: bool = True) -> None:
        super().__init__()
        hidden = c_out // 2
        self.n = n
        self.cv1 = ConvBN(c_in, hidden, 1)
        for i in range(n):
            setattr(self, f"m{i}", BottleneckV5(hidden, shortcut))
        self.cv2 = ConvBN(c_in, hidden, 1)
        self.cv3 = ConvBN(2 * hidden, c_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.cv1(x)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a)
        return self.cv3(torch.cat([a, self.cv2(x)], dim=1))


class YoloV5(nn.Module):
    """YOLOv5 detector; the default scales give v5n.  Input (B, 3, S, S) in
    the weights' dtype, scaled to [0, 1], RGB."""

    def __init__(
        self, num_classes: int = 1, width: float = 0.25, depth: float = 0.33,
        anchor_free: bool = False, reg_max: int = 16,
    ) -> None:
        super().__init__()
        self.num_classes, self.anchor_free, self.reg_max = num_classes, anchor_free, reg_max
        c = self.channels = tuple(
            make_divisible(ch * width) for ch in (64, 128, 256, 512, 1024)
        )
        d = [scale_depth(n, depth) for n in (3, 6, 9, 3)]
        # the v5 yaml's stem is Conv(64, 6, 2, p=2), not autopad
        self.stem = ConvBN(3, c[0], 6, 2, padding=2)
        self.down1 = ConvBN(c[0], c[1], 3, 2)
        self.c3_1 = C3(c[1], c[1], d[0])
        self.down2 = ConvBN(c[1], c[2], 3, 2)
        self.c3_2 = C3(c[2], c[2], d[1])
        self.down3 = ConvBN(c[2], c[3], 3, 2)
        self.c3_3 = C3(c[3], c[3], d[2])
        self.down4 = ConvBN(c[3], c[4], 3, 2)
        self.c3_4 = C3(c[4], c[4], d[3])
        self.sppf = SPPF(c[4], c[4], 5)
        self.td_cv5 = ConvBN(c[4], c[3], 1)
        self.td_p4 = C3(2 * c[3], c[3], d[0], shortcut=False)
        self.td_cv4 = ConvBN(c[3], c[2], 1)
        self.td_p3 = C3(2 * c[2], c[2], d[0], shortcut=False)
        self.bu_down3 = ConvBN(c[2], c[2], 3, 2)
        self.bu_p4 = C3(2 * c[2], c[3], d[0], shortcut=False)
        self.bu_down4 = ConvBN(c[3], c[3], 3, 2)
        self.bu_p5 = C3(2 * c[3], c[4], d[0], shortcut=False)

        feats = (c[2], c[3], c[4])
        if anchor_free:
            c_reg = max(16, c[2] // 4, 4 * reg_max)
            c_cls = max(c[2], min(num_classes, 100))
            for i, f in enumerate(feats):
                setattr(self, f"reg{i}_cv1", ConvBN(f, c_reg, 3))
                setattr(self, f"reg{i}_cv2", ConvBN(c_reg, c_reg, 3))
                setattr(self, f"reg{i}_out", nn.Conv2d(c_reg, 4 * reg_max, 1))
                setattr(self, f"cls{i}_cv1", ConvBN(f, c_cls, 3))
                setattr(self, f"cls{i}_cv2", ConvBN(c_cls, c_cls, 3))
                setattr(self, f"cls{i}_out", nn.Conv2d(c_cls, num_classes, 1))
        else:
            for i, f in enumerate(feats):
                setattr(self, f"head{i}", nn.Conv2d(f, 3 * (5 + num_classes), 1))
        if anchor_free:
            # The u-variant keeps torch's one-rounding bf16 SiLU.  Rounded at
            # each step as the JAX program (every other detector), its one
            # valid detection in tests/test_torch_bf16_zoo_parity.py lands
            # one bf16 ulp of logit from JAX's, 59.9x that test's bound (JAX's
            # drift at that one slot, 1/64 ulp); the differences are conv-
            # order noise carried through the net (ROADMAP section 3).
            for m in self.modules():
                if isinstance(m, ConvBN) and m.act is silu:
                    m.act = F.silu

    def _features(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.c3_1(self.down1(self.stem(x)))
        p3 = self.c3_2(self.down2(x))
        p4 = self.c3_3(self.down3(p3))
        p5 = self.sppf(self.c3_4(self.down4(p4)))
        t5 = self.td_cv5(p5)
        t4 = self.td_p4(torch.cat([upsample2x_nearest(t5), p4], dim=1))
        t4r = self.td_cv4(t4)
        n3 = self.td_p3(torch.cat([upsample2x_nearest(t4r), p3], dim=1))
        n4 = self.bu_p4(torch.cat([self.bu_down3(n3), t4r], dim=1))
        n5 = self.bu_p5(torch.cat([self.bu_down4(n4), t5], dim=1))
        return n3, n4, n5

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self._features(x)
        if self.anchor_free:
            reg_out, cls_out = [], []
            for i, f in enumerate(feats):
                r = getattr(self, f"reg{i}_cv2")(getattr(self, f"reg{i}_cv1")(f))
                k = getattr(self, f"cls{i}_cv2")(getattr(self, f"cls{i}_cv1")(f))
                reg_out.append(flatten_anchors(getattr(self, f"reg{i}_out")(r)))
                cls_out.append(flatten_anchors(getattr(self, f"cls{i}_out")(k)))
            return {"reg": torch.cat(reg_out, dim=1), "cls": torch.cat(cls_out, dim=1)}
        # (B, cells * 3, 5 + nc): cells row-major, 3 priors each, P3..P5
        outs = [
            flatten_anchors(getattr(self, f"head{i}")(f)).reshape(
                f.shape[0], -1, 5 + self.num_classes
            ).float()
            for i, f in enumerate(feats)
        ]
        return {"pred": torch.cat(outs, dim=1)}


def v5_anchor_table(
    input_size: int = 640,
    strides: Sequence[int] = (8, 16, 32),
    anchors=V5_ANCHORS,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-prediction (grid_xy (A, 2), stride (A, 1), anchor_wh (A, 2))
    float32 tables in the head's flatten order: cells row-major, 3 priors
    per cell, P3..P5."""
    grids, strides_out, priors = [], [], []
    for s, level_anchors in zip(strides, anchors):
        n = input_size // s
        xs = np.arange(n, dtype=np.float32)
        gx, gy = np.meshgrid(xs, xs)
        cell_xy = np.stack([gx.reshape(-1), gy.reshape(-1)], -1)
        grids.append(np.repeat(cell_xy, 3, axis=0))
        strides_out.append(np.full((n * n * 3, 1), float(s), np.float32))
        priors.append(np.tile(np.asarray(level_anchors, np.float32), (n * n, 1)))
    return np.concatenate(grids), np.concatenate(strides_out), np.concatenate(priors)


def _v5_boxes(p, grid_xy, strides, anchor_wh) -> torch.Tensor:
    """Sigmoided (..., 4) box terms -> xyxy input pixels (v5 decode)."""
    xy = (2.0 * p[..., 0:2] - 0.5 + grid_xy) * strides
    wh = (2.0 * p[..., 2:4]) ** 2 * anchor_wh
    return torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)


def decode_v5(pred, grid_xy, strides, anchor_wh):
    """Every prediction (B, A, 5 + nc) -> (boxes (B, A, 4) xyxy pixels,
    scores = objectness x class probability maxima, class ids int32)."""
    p = sigmoid(pred)  # in bf16 rounded at each step, as jax.nn.sigmoid
    cls_prob = p[..., 5:] * p[..., 4:5]
    boxes = _v5_boxes(p, grid_xy, strides, anchor_wh)
    return boxes, cls_prob.amax(-1), cls_prob.argmax(-1).to(torch.int32)


def v5_candidates(pred, grid_xy, strides, anchor_wh, k: int = 512):
    """Top-``k`` score-descending candidates of the raw head output (B, A,
    5 + nc): (boxes (B, K, 4) xyxy pixels, scores (B, K), class ids (B, K)
    int32), float32.  Ties go to the lower index, as ``jax.lax.top_k``;
    only the K selected rows are box-decoded."""
    obj = torch.sigmoid(pred[..., 4].float())
    cls_p = torch.sigmoid(pred[..., 5:].float())
    scores = cls_p.amax(-1) * obj
    class_ids = cls_p.argmax(-1).to(torch.int32)
    k = min(k, scores.shape[-1])
    top_scores, idx = topk_stable(scores, k)
    sel = torch.gather(pred[..., :4].float(), 1, idx[..., None].expand(-1, -1, 4))
    boxes = _v5_boxes(torch.sigmoid(sel), grid_xy[idx], strides[idx], anchor_wh[idx])
    return boxes, top_scores, torch.gather(class_ids, 1, idx)


class V5CandidateDecoder:
    """The pipeline's ``candidate_decoder`` for the anchor-based head:
    ``decoder(out, k)`` runs :func:`v5_candidates` on ``out["pred"]`` with
    the anchor table made once on ``device`` (no host copy per call).
    ``capacity`` is the head's prediction count, the pipeline's
    ``candidate_capacity`` (3 x the anchor-free grid: 25,200 at 640)."""

    def __init__(self, input_size: int = 640, device="cuda") -> None:
        dev = resolve_device(device)
        tables = v5_anchor_table(input_size)
        self.grid_xy, self.strides, self.anchor_wh = (
            torch.from_numpy(t).to(dev) for t in tables
        )
        self.capacity = int(tables[0].shape[0])

    def __call__(self, out: Dict[str, torch.Tensor], k: int):
        return v5_candidates(out["pred"], self.grid_xy, self.strides, self.anchor_wh, k)
