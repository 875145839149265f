"""Reference YOLO-LitePi detector (yolo_plus_v2: a channel-pruned YOLOv8n;
vinhisreal/YOLO-LitePi), plain float32, BatchNorm unfolded.

Backbone: stem 3x3/2, then four (3x3/2 down conv, C2f) stages and SPPF.
Neck: PAN, top-down then bottom-up, C2f with residual bottlenecks.  Head:
decoupled per level, a DFL box branch (4 x ``reg_max`` bins) and a class
branch.  Output ``reg`` (B, A, 4*reg_max), ``cls`` (B, A, nc) logits,
anchors row-major over (y, x) per level, P3..P5.
"""

from __future__ import annotations

import torch
from torch import nn

from cardbench.reference.layers import C2f, SPPF, ConvBN, flatten_anchors, make_divisible
from cardbench.reference.layers import scale_depth, upsample2x


class Backbone(nn.Module):
    def __init__(self, c, d):
        super().__init__()
        self.stem = ConvBN(3, c[0], 3, 2)
        self.down1 = ConvBN(c[0], c[1], 3, 2)
        self.c2f1 = C2f(c[1], c[1], d[0], True)
        self.down2 = ConvBN(c[1], c[2], 3, 2)
        self.c2f2 = C2f(c[2], c[2], d[1], True)
        self.down3 = ConvBN(c[2], c[3], 3, 2)
        self.c2f3 = C2f(c[3], c[3], d[2], True)
        self.down4 = ConvBN(c[3], c[4], 3, 2)
        self.c2f4 = C2f(c[4], c[4], d[3], True)
        self.sppf = SPPF(c[4], c[4], 5)

    def forward(self, x):
        x = self.c2f1(self.down1(self.stem(x)))
        p3 = self.c2f2(self.down2(x))
        p4 = self.c2f3(self.down3(p3))
        return p3, p4, self.sppf(self.c2f4(self.down4(p4)))


class PANNeck(nn.Module):
    def __init__(self, c, n, shortcut, dn3, dn4):
        super().__init__()
        self.td_p4 = C2f(c[4] + c[3], c[3], n, shortcut)
        self.td_p3 = C2f(c[3] + c[2], c[2], n, shortcut)
        self.bu_down3 = ConvBN(c[2], dn3, 3, 2)
        self.bu_p4 = C2f(dn3 + c[3], c[3], n, shortcut)
        self.bu_down4 = ConvBN(c[3], dn4, 3, 2)
        self.bu_p5 = C2f(dn4 + c[4], c[4], n, shortcut)

    def forward(self, feats):
        p3, p4, p5 = feats
        t4 = self.td_p4(torch.cat([upsample2x(p5), p4], dim=1))
        n3 = self.td_p3(torch.cat([upsample2x(t4), p3], dim=1))
        n4 = self.bu_p4(torch.cat([self.bu_down3(n3), t4], dim=1))
        n5 = self.bu_p5(torch.cat([self.bu_down4(n4), p5], dim=1))
        return n3, n4, n5


class DetectHead(nn.Module):
    def __init__(self, in_ch, c_reg, c_cls, reg_max, nc):
        super().__init__()
        for i, c in enumerate(in_ch):
            setattr(self, f"reg{i}_cv1", ConvBN(c, c_reg, 3))
            setattr(self, f"reg{i}_cv2", ConvBN(c_reg, c_reg, 3))
            setattr(self, f"reg{i}_out", nn.Conv2d(c_reg, 4 * reg_max, 1))
            setattr(self, f"cls{i}_cv1", ConvBN(c, c_cls, 3))
            setattr(self, f"cls{i}_cv2", ConvBN(c_cls, c_cls, 3))
            setattr(self, f"cls{i}_out", nn.Conv2d(c_cls, nc, 1))

    def forward(self, feats):
        reg, cls = [], []
        for i, f in enumerate(feats):
            r = getattr(self, f"reg{i}_cv2")(getattr(self, f"reg{i}_cv1")(f))
            k = getattr(self, f"cls{i}_cv2")(getattr(self, f"cls{i}_cv1")(f))
            reg.append(flatten_anchors(getattr(self, f"reg{i}_out")(r)))
            cls.append(flatten_anchors(getattr(self, f"cls{i}_out")(k)))
        return {"reg": torch.cat(reg, dim=1), "cls": torch.cat(cls, dim=1)}


class YoloLitePi(nn.Module):
    """Input (B, 3, S, S) RGB in [0, 1]."""

    def __init__(self, spec: dict):
        super().__init__()
        width, depth = spec["width"], spec["depth"]
        c = [make_divisible(ch * width) for ch in spec["base_channels"]]
        d = [scale_depth(n, depth) for n in spec["base_depths"]]
        base = spec["base_channels"]
        dn3, dn4 = (make_divisible(ch * width) for ch in (base[2], base[3]))
        nc, reg_max = spec["num_classes"], spec["reg_max"]
        self.backbone = Backbone(c, d)
        self.neck = PANNeck(c, d[0], True, dn3, dn4)
        self.head = DetectHead((c[2], c[3], c[4]), max(16, c[2] // 4, 4 * reg_max),
                               max(c[2], min(nc, 100)), reg_max, nc)

    def forward(self, x):
        return self.head(self.neck(self.backbone(x)))


def build(spec: dict) -> nn.Module:
    return YoloLitePi(spec)
