"""Reference Ultralytics YOLO11 detector (``ultralytics/cfg/models/11/
yolo11.yaml``; scale n: depth 0.50, width 0.25), plain float32, BatchNorm
unfolded (eps 1e-3).

C3k2 blocks (C3k inner blocks in the deep stages), SPPF, C2PSA spatial
attention, a PAN neck of C3k2 blocks, a DFL box branch and a
depthwise-separable class branch per level.  Output as the YOLO-LitePi
reference's: ``reg`` (B, A, 4*reg_max), ``cls`` (B, A, nc).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from cardbench.reference.layers import SPPF, Bottleneck, ConvBN, flatten_anchors
from cardbench.reference.layers import make_divisible, scale_depth, upsample2x


class HalfBottleneck(nn.Module):
    def __init__(self, c, shortcut=True):
        super().__init__()
        self.cv1 = ConvBN(c, c // 2, 3)
        self.cv2 = ConvBN(c // 2, c, 3)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C3k(nn.Module):
    def __init__(self, c_in, c_out, shortcut=True):
        super().__init__()
        hidden = c_out // 2
        self.cv1 = ConvBN(c_in, hidden, 1)
        self.m0 = Bottleneck(hidden, shortcut)
        self.m1 = Bottleneck(hidden, shortcut)
        self.cv2 = ConvBN(c_in, hidden, 1)
        self.cv3 = ConvBN(2 * hidden, c_out, 1)

    def forward(self, x):
        return self.cv3(torch.cat([self.m1(self.m0(self.cv1(x))), self.cv2(x)], dim=1))


class C3k2(nn.Module):
    def __init__(self, c_in, c_out, n=1, c3k=False, e=0.5, shortcut=True):
        super().__init__()
        hidden = int(c_out * e)
        self.n = n
        self.cv1 = ConvBN(c_in, 2 * hidden, 1)
        for i in range(n):
            setattr(self, f"m{i}", C3k(hidden, hidden, shortcut) if c3k
                    else HalfBottleneck(hidden, shortcut))
        self.cv2 = ConvBN((2 + n) * hidden, c_out, 1)

    def forward(self, x):
        a, b = self.cv1(x).chunk(2, dim=1)
        outs = [a, b]
        for i in range(self.n):
            b = getattr(self, f"m{i}")(b)
            outs.append(b)
        return self.cv2(torch.cat(outs, dim=1))


class Attention(nn.Module):
    """Multi-head self-attention over the H*W tokens; qkv channels
    ``[q all heads | k all heads | v all heads]``, q/k heads half as wide
    as v's; a depthwise 3x3 positional branch on v."""

    def __init__(self, dim, num_heads, attn_ratio=0.5):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        nh_kd = self.key_dim * num_heads
        self.qkv = ConvBN(dim, dim + 2 * nh_kd, 1, act=None)
        self.pe = ConvBN(dim, dim, 3, groups=dim, act=None)
        self.proj = ConvBN(dim, dim, 1, act=None)

    def forward(self, x):
        b, _, h, w = x.shape
        nh, kd, hd = self.num_heads, self.key_dim, self.head_dim
        qkv = self.qkv(x)
        q = qkv[:, : nh * kd].reshape(b, nh, kd, h * w)
        k = qkv[:, nh * kd: 2 * nh * kd].reshape(b, nh, kd, h * w)
        v = qkv[:, 2 * nh * kd:]
        attn = torch.softmax(q.transpose(2, 3) @ k / math.sqrt(kd), dim=-1)
        y = v.reshape(b, nh, hd, h * w) @ attn.transpose(2, 3)
        return self.proj(y.reshape(b, self.dim, h, w) + self.pe(v))


class PSABlock(nn.Module):
    def __init__(self, dim, num_heads):
        super().__init__()
        self.attn = Attention(dim, num_heads)
        self.ffn1 = ConvBN(dim, dim * 2, 1)
        self.ffn2 = ConvBN(dim * 2, dim, 1, act=None)

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn2(self.ffn1(x))


class C2PSA(nn.Module):
    def __init__(self, c_in, c_out, n=1):
        super().__init__()
        hidden = c_out // 2
        self.n = n
        self.cv1 = ConvBN(c_in, 2 * hidden, 1)
        for i in range(n):
            setattr(self, f"m{i}", PSABlock(hidden, max(hidden // 64, 1)))
        self.cv2 = ConvBN(2 * hidden, c_out, 1)

    def forward(self, x):
        a, b = self.cv1(x).chunk(2, dim=1)
        for i in range(self.n):
            b = getattr(self, f"m{i}")(b)
        return self.cv2(torch.cat([a, b], dim=1))


class YoloV11(nn.Module):
    """Input (B, 3, S, S) RGB in [0, 1]."""

    def __init__(self, spec: dict):
        super().__init__()
        nc, reg_max = spec["num_classes"], spec["reg_max"]
        c = [min(make_divisible(ch * spec["width"]), spec["max_channels"])
             for ch in spec["base_channels"]]
        n = scale_depth(spec["base_repeats"], spec["depth"])
        self.stem = ConvBN(3, c[0], 3, 2)
        self.down1 = ConvBN(c[0], c[1], 3, 2)
        self.c3k2_1 = C3k2(c[1], c[2], n, False, 0.25)
        self.down2 = ConvBN(c[2], c[2], 3, 2)
        self.c3k2_2 = C3k2(c[2], c[3], n, False, 0.25)
        self.down3 = ConvBN(c[3], c[3], 3, 2)
        self.c3k2_3 = C3k2(c[3], c[3], n, True)
        self.down4 = ConvBN(c[3], c[4], 3, 2)
        self.c3k2_4 = C3k2(c[4], c[4], n, True)
        self.sppf = SPPF(c[4], c[4], 5)
        self.c2psa = C2PSA(c[4], c[4], n)
        self.td_p4 = C3k2(c[4] + c[3], c[3], n, False)
        self.td_p3 = C3k2(c[3] + c[3], c[2], n, False)
        self.bu_down3 = ConvBN(c[2], c[2], 3, 2)
        self.bu_p4 = C3k2(c[2] + c[3], c[3], n, False)
        self.bu_down4 = ConvBN(c[3], c[3], 3, 2)
        self.bu_p5 = C3k2(c[3] + c[4], c[4], n, True)
        c_reg = max(16, c[2] // 4, 4 * reg_max)
        c_cls = max(c[2], min(nc, 100))
        for i, f in enumerate((c[2], c[3], c[4])):
            setattr(self, f"reg{i}_cv1", ConvBN(f, c_reg, 3))
            setattr(self, f"reg{i}_cv2", ConvBN(c_reg, c_reg, 3))
            setattr(self, f"reg{i}_out", nn.Conv2d(c_reg, 4 * reg_max, 1))
            setattr(self, f"cls{i}_dw1", ConvBN(f, f, 3, groups=f))
            setattr(self, f"cls{i}_pw1", ConvBN(f, c_cls, 1))
            setattr(self, f"cls{i}_dw2", ConvBN(c_cls, c_cls, 3, groups=c_cls))
            setattr(self, f"cls{i}_pw2", ConvBN(c_cls, c_cls, 1))
            setattr(self, f"cls{i}_out", nn.Conv2d(c_cls, nc, 1))

    def forward(self, x):
        x = self.c3k2_1(self.down1(self.stem(x)))
        p3 = self.c3k2_2(self.down2(x))
        p4 = self.c3k2_3(self.down3(p3))
        p5 = self.c2psa(self.sppf(self.c3k2_4(self.down4(p4))))
        t4 = self.td_p4(torch.cat([upsample2x(p5), p4], dim=1))
        n3 = self.td_p3(torch.cat([upsample2x(t4), p3], dim=1))
        n4 = self.bu_p4(torch.cat([self.bu_down3(n3), t4], dim=1))
        n5 = self.bu_p5(torch.cat([self.bu_down4(n4), p5], dim=1))
        reg, cls = [], []
        for i, f in enumerate((n3, n4, n5)):
            r = getattr(self, f"reg{i}_cv2")(getattr(self, f"reg{i}_cv1")(f))
            reg.append(flatten_anchors(getattr(self, f"reg{i}_out")(r)))
            k = f
            for name in ("dw1", "pw1", "dw2", "pw2", "out"):
                k = getattr(self, f"cls{i}_{name}")(k)
            cls.append(flatten_anchors(k))
        return {"reg": torch.cat(reg, dim=1), "cls": torch.cat(cls, dim=1)}


def build(spec: dict) -> nn.Module:
    return YoloV11(spec)
