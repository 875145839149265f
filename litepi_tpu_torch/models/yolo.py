"""The YOLO-LitePi detector (backbone + PAN neck + decoupled DFL head).

Modules take (B, C, H, W) tensors in either dense layout and keep it:
``TwoStagePipeline`` runs the detector channels last on the card, where
cuDNN's convs are NHWC (``layers.py::to_channels_last``), and NCHW on the
CPU.  The head returns the JAX package's layout: ``reg`` (B, A,
4*reg_max) and ``cls`` (B, A, nc) raw logits, anchors flattened row-major
(y, x) per level and P3..P5 concatenated (A = 8,400 at 640).  Module names follow the Flax names
(``backbone.stem``, ``neck.td_p4``, ``head.reg0_out``, ...).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from litepi_tpu_torch.core.types import DetectorConfig
from litepi_tpu_torch.models.layers import C2f, ConvBN, SPPF, flatten_anchors, upsample2x_nearest


class Backbone(nn.Module):
    def __init__(self, cfg: DetectorConfig, fused: bool = False) -> None:
        super().__init__()
        c, d = cfg.channels, cfg.depths
        self.stem = ConvBN(3, c[0], 3, 2, fused=fused)
        self.down1 = ConvBN(c[0], c[1], 3, 2, fused=fused)
        self.c2f1 = C2f(c[1], c[1], d[0], True, fused)
        self.down2 = ConvBN(c[1], c[2], 3, 2, fused=fused)
        self.c2f2 = C2f(c[2], c[2], d[1], True, fused)
        self.down3 = ConvBN(c[2], c[3], 3, 2, fused=fused)
        self.c2f3 = C2f(c[3], c[3], d[2], True, fused)
        self.down4 = ConvBN(c[3], c[4], 3, 2, fused=fused)
        self.c2f4 = C2f(c[4], c[4], d[3], True, fused)
        self.sppf = SPPF(c[4], c[4], 5, fused)

    def forward(
        self, x: torch.Tensor, from_stem: bool = False
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if not from_stem:
            x = self.stem(x)
        # else: x is the stem activation (B, c0, H/2, W/2), computed by the
        # caller (the fused pipeline's raw-input stem, or a stem kernel)
        x = self.c2f1(self.down1(x))
        p3 = self.c2f2(self.down2(x))
        p4 = self.c2f3(self.down3(p3))
        x = self.c2f4(self.down4(p4))
        return p3, p4, self.sppf(x)


class PANNeck(nn.Module):
    """Path-aggregation neck: top-down then bottom-up feature fusion."""

    def __init__(self, cfg: DetectorConfig, fused: bool = False) -> None:
        super().__init__()
        c = cfg.channels
        n = cfg.depths[0]
        sc = cfg.neck_shortcut
        dn3, dn4 = cfg.neck_down_channels
        self.td_p4 = C2f(c[4] + c[3], c[3], n, sc, fused)
        self.td_p3 = C2f(c[3] + c[2], c[2], n, sc, fused)
        self.bu_down3 = ConvBN(c[2], dn3, 3, 2, fused=fused)
        self.bu_p4 = C2f(dn3 + c[3], c[3], n, sc, fused)
        self.bu_down4 = ConvBN(c[3], dn4, 3, 2, fused=fused)
        self.bu_p5 = C2f(dn4 + c[4], c[4], n, sc, fused)

    def forward(self, feats):
        p3, p4, p5 = feats
        t4 = self.td_p4(torch.cat([upsample2x_nearest(p5), p4], dim=1))
        n3 = self.td_p3(torch.cat([upsample2x_nearest(t4), p3], dim=1))
        n4 = self.bu_p4(torch.cat([self.bu_down3(n3), t4], dim=1))
        n5 = self.bu_p5(torch.cat([self.bu_down4(n4), p5], dim=1))
        return n3, n4, n5


class DetectHead(nn.Module):
    """Decoupled anchor-free head: per-level DFL box + class branches."""

    def __init__(self, cfg: DetectorConfig, fused: bool = False) -> None:
        super().__init__()
        self.cfg = cfg
        c_reg, c_cls = cfg.reg_channels, cfg.cls_channels
        in_ch = (cfg.channels[2], cfg.channels[3], cfg.channels[4])
        for i, c in enumerate(in_ch):
            setattr(self, f"reg{i}_cv1", ConvBN(c, c_reg, 3, fused=fused))
            setattr(self, f"reg{i}_cv2", ConvBN(c_reg, c_reg, 3, fused=fused))
            setattr(self, f"reg{i}_out", nn.Conv2d(c_reg, 4 * cfg.reg_max, 1))
            setattr(self, f"cls{i}_cv1", ConvBN(c, c_cls, 3, fused=fused))
            setattr(self, f"cls{i}_cv2", ConvBN(c_cls, c_cls, 3, fused=fused))
            setattr(self, f"cls{i}_out", nn.Conv2d(c_cls, cfg.num_classes, 1))

    def forward(self, feats) -> Dict[str, torch.Tensor]:
        reg_out, cls_out = [], []
        for i, f in enumerate(feats):
            r = getattr(self, f"reg{i}_cv2")(getattr(self, f"reg{i}_cv1")(f))
            r = getattr(self, f"reg{i}_out")(r)
            k = getattr(self, f"cls{i}_cv2")(getattr(self, f"cls{i}_cv1")(f))
            k = getattr(self, f"cls{i}_out")(k)
            reg_out.append(flatten_anchors(r))
            cls_out.append(flatten_anchors(k))
        return {"reg": torch.cat(reg_out, dim=1), "cls": torch.cat(cls_out, dim=1)}


class YoloLitePi(nn.Module):
    """Full detector.  Input (B, 3, S, S) in the weights' dtype, letterboxed
    and scaled to [0, 1] (or raw 0-255 with a stem-input-folded kernel)."""

    def __init__(self, cfg: DetectorConfig, fused: bool = False) -> None:
        super().__init__()
        self.cfg = cfg
        self.fused = fused
        self.backbone = Backbone(cfg, fused)
        self.neck = PANNeck(cfg, fused)
        self.head = DetectHead(cfg, fused)

    def forward(
        self, x: torch.Tensor, from_stem: bool = False
    ) -> Dict[str, torch.Tensor]:
        feats = self.backbone(x, from_stem)
        return self.head(self.neck(feats))
