"""Reference Ultralytics YOLO12 detector at scale l
(``ultralytics/cfg/models/12/yolo12.yaml``: depth 1.0, width 1.0,
max_channels 512; arXiv:2502.12524), plain float32, BatchNorm unfolded (eps
1e-3).

The layer table of the yaml as ``parse_model`` builds it at scale l (every
C3k2 with C3k inner blocks, every A2C2f with ``residual=True`` and
``mlp_ratio=1.2``), each block written out as the published code computes
it:

* ``AAttn(dim, heads, area)``: ``qkv`` a 1x1 conv to 3*dim (no act); the
  row-major tokens cut into ``area`` contiguous chunks; per chunk and head
  (channels head-major: each head's 96 channels are [q | k | v]),
  ``softmax(q^T k / sqrt(32))`` applied to v, as explicit matrix products
  and a softmax; ``proj(x + pe(v))``, ``pe`` a depthwise 7x7 conv (no act);
* ``ABlock``: ``x + attn(x)``, then ``x + mlp(x)``, the MLP 1x1 convs
  dim -> int(1.2 dim) (SiLU) -> dim (no act);
* ``A2C2f``: ``cv1``, n blocks of two ABlocks (or a C3k), ``cv2`` on the
  concatenation, and with area attention ``x + gamma * out``;
* v11's C3k2 / C3k (``cardbench/reference/yolov11.py``) and Detect head.

Departures from the published code: the module names are the program's
(``stem``, ``a2c2f_p4.m0.0.attn.qkv``, ``reg0_out``, ...), and the DFL
conv is not a module (the decode is ``reference/two_stage.py``'s); the
attention is computed a block of chunks at a time, so that the scores of a
32-frame batch at 1280 fit on one card (the same products, in pieces);
the benchmark draws ``gamma`` as any bias, N(0, 0.1^2) (``cardbench/
weights.py``), where Ultralytics initialises it to 0.01.
"""

from __future__ import annotations

import torch
from torch import nn

from cardbench.reference.layers import ConvBN, flatten_anchors, upsample2x
from cardbench.reference.yolov11 import C3k, C3k2

SCALE_L = {"width": 1.0, "depth": 1.0, "max_channels": 512}
HEAD_DIM = 32
CHUNK_ROWS = 16  # (chunk, head) score matrices computed at once per 16 chunks


class AAttn(nn.Module):
    def __init__(self, dim, num_heads, area=1):
        super().__init__()
        self.area, self.num_heads = area, num_heads
        self.head_dim = dim // num_heads
        self.qkv = ConvBN(dim, 3 * dim, 1, act=None)
        self.proj = ConvBN(dim, dim, 1, act=None)
        self.pe = ConvBN(dim, dim, 7, groups=dim, act=None)

    def forward(self, x):
        b, c, h, w = x.shape
        nh, hd = self.num_heads, self.head_dim
        n = h * w // self.area
        qkv = self.qkv(x).flatten(2).transpose(1, 2).reshape(b * self.area, n, 3 * c)
        q, k, v = qkv.view(b * self.area, n, nh, 3 * hd).permute(0, 2, 3, 1).split(hd, dim=2)
        out = torch.empty_like(v)  # (chunks, heads, hd, n)
        for i in range(0, q.shape[0], CHUNK_ROWS):
            s = slice(i, i + CHUNK_ROWS)
            attn = torch.softmax((q[s].transpose(-2, -1) @ k[s]) * hd ** -0.5, dim=-1)
            out[s] = v[s] @ attn.transpose(-2, -1)
        x = out.permute(0, 3, 1, 2).reshape(b, h, w, c).permute(0, 3, 1, 2)
        v = v.permute(0, 3, 1, 2).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj(x + self.pe(v))


class ABlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=1.2, area=1):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.attn = AAttn(dim, num_heads, area)
        self.mlp = nn.Sequential(ConvBN(dim, hidden, 1), ConvBN(hidden, dim, 1, act=None))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp(x)


class A2C2f(nn.Module):
    def __init__(self, c_in, c_out, n=1, a2=True, area=1, residual=False, mlp_ratio=1.2,
                 e=0.5):
        super().__init__()
        hidden = int(c_out * e)
        self.n = n
        self.cv1 = ConvBN(c_in, hidden, 1)
        self.cv2 = ConvBN((1 + n) * hidden, c_out, 1)
        self.gamma = nn.Parameter(0.01 * torch.ones(c_out)) if a2 and residual else None
        for i in range(n):
            setattr(self, f"m{i}", nn.Sequential(
                *(ABlock(hidden, hidden // HEAD_DIM, mlp_ratio, area) for _ in range(2)))
                if a2 else C3k(hidden, hidden))

    def forward(self, x):
        y = [self.cv1(x)]
        for i in range(self.n):
            y.append(getattr(self, f"m{i}")(y[-1]))
        y = self.cv2(torch.cat(y, 1))
        if self.gamma is not None:
            return x + self.gamma.view(-1, len(self.gamma), 1, 1) * y
        return y


class Yolo12L(nn.Module):
    """Input (B, 3, S, S) RGB in [0, 1]."""

    def __init__(self, nc, reg_max):
        super().__init__()
        self.stem = ConvBN(3, 64, 3, 2)                            # 0  P1/2
        self.down1 = ConvBN(64, 128, 3, 2, groups=2)               # 1  P2/4
        self.c3k2_1 = C3k2(128, 256, 2, True, 0.25)                # 2
        self.down2 = ConvBN(256, 256, 3, 2, groups=4)              # 3  P3/8
        self.c3k2_2 = C3k2(256, 512, 2, True, 0.25)                # 4
        self.down3 = ConvBN(512, 512, 3, 2)                        # 5  P4/16
        self.a2c2f_p4 = A2C2f(512, 512, 4, True, 4, True)          # 6
        self.down4 = ConvBN(512, 512, 3, 2)                        # 7  P5/32
        self.a2c2f_p5 = A2C2f(512, 512, 4, True, 1, True)          # 8
        self.td_p4 = A2C2f(1024, 512, 2, False, -1, True)          # 9-11
        self.td_p3 = A2C2f(1024, 256, 2, False, -1, True)          # 12-14
        self.bu_down3 = ConvBN(256, 256, 3, 2)                     # 15
        self.bu_p4 = A2C2f(768, 512, 2, False, -1, True)           # 16-17
        self.bu_down4 = ConvBN(512, 512, 3, 2)                     # 18
        self.bu_p5 = C3k2(1024, 512, 2, True)                      # 19-20
        c_reg = max(16, 256 // 4, 4 * reg_max)                     # 21 Detect
        c_cls = max(256, min(nc, 100))
        for i, f in enumerate((256, 512, 512)):
            setattr(self, f"reg{i}_cv1", ConvBN(f, c_reg, 3))
            setattr(self, f"reg{i}_cv2", ConvBN(c_reg, c_reg, 3))
            setattr(self, f"reg{i}_out", nn.Conv2d(c_reg, 4 * reg_max, 1))
            setattr(self, f"cls{i}_dw1", ConvBN(f, f, 3, groups=f))
            setattr(self, f"cls{i}_pw1", ConvBN(f, c_cls, 1))
            setattr(self, f"cls{i}_dw2", ConvBN(c_cls, c_cls, 3, groups=c_cls))
            setattr(self, f"cls{i}_pw2", ConvBN(c_cls, c_cls, 1))
            setattr(self, f"cls{i}_out", nn.Conv2d(c_cls, nc, 1))

    def forward(self, x):
        p3 = self.c3k2_2(self.down2(self.c3k2_1(self.down1(self.stem(x)))))
        p4 = self.a2c2f_p4(self.down3(p3))
        p5 = self.a2c2f_p5(self.down4(p4))
        t4 = self.td_p4(torch.cat([upsample2x(p5), p4], 1))
        n3 = self.td_p3(torch.cat([upsample2x(t4), p3], 1))
        n4 = self.bu_p4(torch.cat([self.bu_down3(n3), t4], 1))
        n5 = self.bu_p5(torch.cat([self.bu_down4(n4), p5], 1))
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
    scale = {k: spec.get(k) for k in SCALE_L}
    if scale != SCALE_L:
        raise ValueError(f"the YOLO12 reference is scale l {SCALE_L}, not {scale}")
    return Yolo12L(spec["num_classes"], spec["reg_max"])
