"""Reference Ultralytics YOLOv9-E detector (``ultralytics/cfg/models/v9/
yolov9e.yaml``; Wang, Yeh and Liao, arXiv:2402.13616), plain float32,
BatchNorm unfolded (eps 1e-3), every ``RepConv`` with both its branches as
trained.

The layer table of the yaml, each block written out as the published code
computes it:

* ``RepConv(c1, c2)``: ``silu(conv1(x) + conv2(x))``, ``conv1`` a 3x3
  ConvBN and ``conv2`` a 1x1 ConvBN, neither with an activation (no
  identity branch: RepBottleneck builds it with ``bn=False``);
* ``RepBottleneck(c)``: ``x + cv2(cv1(x))``, ``cv1`` a RepConv, ``cv2`` a
  3x3 ConvBN; ``RepCSP(c1, c2, n=2)``: C3 with RepBottlenecks,
  ``cv3(cat(m(cv1 x), cv2 x))``;
* ``RepNCSPELAN4(c1, c2, c3, c4)``: ``cv1`` 1x1 to c3 split in halves a,
  b; ``cv2`` = RepCSP(c3/2, c4) then a 3x3 ConvBN on b; ``cv3`` = RepCSP(c4,
  c4) then a 3x3 ConvBN on that; ``cv4`` 1x1 on the four parts;
* ``ADown(c1, c2)``: a 2x2 stride-1 average pool, halves through a 3x3/2
  ConvBN and through a 3x3/2 max pool then a 1x1 ConvBN;
* ``SPPELAN(c1, c2, c3)``: 1x1 to c3, three chained 5x5 max pools, 1x1 on
  the four;
* ``CBLinear(c1, c2s)``: one biased 1x1 conv, split along channels;
  ``CBFuse``: each source resized to the target's size (nearest), summed
  with the target;
* the first backbone (layers 1-9) and its five ``CBLinear`` projections
  (10-14), the second backbone (15-29) with a ``CBFuse`` at each of its
  five levels, the PAN head (30-41) and v8's ``Detect`` on P3, P4, P5.

Departures from the published code: the module names are the program's
(``elan3``, ``down4``, ``cbl10``, ``fuse16``, ``head.reg0_out``, ...; inside
the blocks Ultralytics' own); the DFL conv is not a module (the decode is
``reference/two_stage.py``'s).  Departures of memory only: ``CBFuse`` adds
one resized source at a time, in the published order (sources, then the
target), where Ultralytics stacks all six maps and sums the stack (a 32-frame
stack at P1 and 1280 would take 20 GB in float32; its reduction may group the
float32 adds otherwise); each ``CBLinear`` runs as soon as its tap exists, so
that the first backbone's maps are freed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cardbench.reference.layers import ConvBN, flatten_anchors, upsample2x


class RepConv(nn.Module):
    def __init__(self, c1, c2):
        super().__init__()
        self.conv1 = ConvBN(c1, c2, 3, act=None)
        self.conv2 = ConvBN(c1, c2, 1, act=None)

    def forward(self, x):
        return F.silu(self.conv1(x) + self.conv2(x))


class RepBottleneck(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.cv1 = RepConv(c, c)
        self.cv2 = ConvBN(c, c, 3)

    def forward(self, x):
        return x + self.cv2(self.cv1(x))


class RepCSP(nn.Module):
    def __init__(self, c1, c2, n=2):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = ConvBN(c1, c_, 1)
        self.cv2 = ConvBN(c1, c_, 1)
        self.cv3 = ConvBN(2 * c_, c2, 1)
        self.m = nn.Sequential(*(RepBottleneck(c_) for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat((self.m(self.cv1(x)), self.cv2(x)), 1))


class RepNCSPELAN4(nn.Module):
    def __init__(self, c1, c2, c3, c4, n=2):
        super().__init__()
        self.cv1 = ConvBN(c1, c3, 1)
        self.cv2 = nn.Sequential(RepCSP(c3 // 2, c4, n), ConvBN(c4, c4, 3))
        self.cv3 = nn.Sequential(RepCSP(c4, c4, n), ConvBN(c4, c4, 3))
        self.cv4 = ConvBN(c3 + 2 * c4, c2, 1)

    def forward(self, x):
        y = list(self.cv1(x).chunk(2, 1))
        y.append(self.cv2(y[-1]))
        y.append(self.cv3(y[-1]))
        return self.cv4(torch.cat(y, 1))


class ADown(nn.Module):
    def __init__(self, c1, c2):
        super().__init__()
        self.cv1 = ConvBN(c1 // 2, c2 // 2, 3, 2, padding=1)
        self.cv2 = ConvBN(c1 // 2, c2 // 2, 1, 1, padding=0)

    def forward(self, x):
        x = F.avg_pool2d(x, 2, 1, 0, False, True)
        x1, x2 = x.chunk(2, 1)
        x1 = self.cv1(x1)
        x2 = self.cv2(F.max_pool2d(x2, 3, 2, 1))
        return torch.cat((x1, x2), 1)


class SPPELAN(nn.Module):
    def __init__(self, c1, c2, c3, k=5):
        super().__init__()
        self.k = k
        self.cv1 = ConvBN(c1, c3, 1)
        self.cv5 = ConvBN(4 * c3, c2, 1)

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], self.k, 1, self.k // 2))
        return self.cv5(torch.cat(y, 1))


class CBLinear(nn.Module):
    def __init__(self, c1, c2s):
        super().__init__()
        self.c2s = list(c2s)
        self.conv = nn.Conv2d(c1, sum(c2s), 1, bias=True)

    def forward(self, x):
        return self.conv(x).split(self.c2s, dim=1)


class CBFuse(nn.Module):
    """``xs``: the ``CBLinear`` outputs (tuples of splits), then the target;
    source i is split ``idx[i]`` of ``xs[i]``, resized to the target's size
    (nearest) and summed in the published order, one source at a time."""

    def __init__(self, idx):
        super().__init__()
        self.idx = list(idx)

    def forward(self, xs):
        target = xs[-1]
        size = target.shape[2:]
        out = None
        for i, x in enumerate(xs[:-1]):
            s = F.interpolate(x[self.idx[i]], size=size, mode="nearest")
            out = s if out is None else out + s
        return out + target


class Head(nn.Module):
    """v8's Detect without its DFL conv: per level a box branch (two 3x3
    ConvBN, a 1x1 conv to 4 reg_max) and a class branch (two 3x3 ConvBN, a
    1x1 conv to nc)."""

    def __init__(self, nc, reg_max, channels=(256, 512, 512)):
        super().__init__()
        c_reg = max(16, channels[0] // 4, 4 * reg_max)
        c_cls = max(channels[0], min(nc, 100))
        for i, f in enumerate(channels):
            setattr(self, f"reg{i}_cv1", ConvBN(f, c_reg, 3))
            setattr(self, f"reg{i}_cv2", ConvBN(c_reg, c_reg, 3))
            setattr(self, f"reg{i}_out", nn.Conv2d(c_reg, 4 * reg_max, 1))
            setattr(self, f"cls{i}_cv1", ConvBN(f, c_cls, 3))
            setattr(self, f"cls{i}_cv2", ConvBN(c_cls, c_cls, 3))
            setattr(self, f"cls{i}_out", nn.Conv2d(c_cls, nc, 1))

    def forward(self, feats):
        reg, cls = [], []
        for i, f in enumerate(feats):
            r = getattr(self, f"reg{i}_cv2")(getattr(self, f"reg{i}_cv1")(f))
            reg.append(flatten_anchors(getattr(self, f"reg{i}_out")(r)))
            k = getattr(self, f"cls{i}_cv2")(getattr(self, f"cls{i}_cv1")(f))
            cls.append(flatten_anchors(getattr(self, f"cls{i}_out")(k)))
        return {"reg": torch.cat(reg, dim=1), "cls": torch.cat(cls, dim=1)}


class YoloV9E(nn.Module):
    """Input (B, 3, S, S) RGB in [0, 1], S a multiple of 32."""

    def __init__(self, nc, reg_max):
        super().__init__()
        self.conv1 = ConvBN(3, 64, 3, 2)                           # 1  P1/2
        self.conv2 = ConvBN(64, 128, 3, 2)                         # 2  P2/4
        self.elan3 = RepNCSPELAN4(128, 256, 128, 64)               # 3
        self.down4 = ADown(256, 256)                               # 4  P3/8
        self.elan5 = RepNCSPELAN4(256, 512, 256, 128)              # 5
        self.down6 = ADown(512, 512)                               # 6  P4/16
        self.elan7 = RepNCSPELAN4(512, 1024, 512, 256)             # 7
        self.down8 = ADown(1024, 1024)                             # 8  P5/32
        self.elan9 = RepNCSPELAN4(1024, 1024, 512, 256)            # 9
        self.cbl10 = CBLinear(64, [64])                            # 10
        self.cbl11 = CBLinear(256, [64, 128])                      # 11
        self.cbl12 = CBLinear(512, [64, 128, 256])                 # 12
        self.cbl13 = CBLinear(1024, [64, 128, 256, 512])           # 13
        self.cbl14 = CBLinear(1024, [64, 128, 256, 512, 1024])     # 14
        self.conv15 = ConvBN(3, 64, 3, 2)                          # 15 P1/2
        self.fuse16 = CBFuse([0, 0, 0, 0, 0])                      # 16
        self.conv17 = ConvBN(64, 128, 3, 2)                        # 17 P2/4
        self.fuse18 = CBFuse([1, 1, 1, 1])                         # 18
        self.elan19 = RepNCSPELAN4(128, 256, 128, 64)              # 19
        self.down20 = ADown(256, 256)                              # 20 P3/8
        self.fuse21 = CBFuse([2, 2, 2])                            # 21
        self.elan22 = RepNCSPELAN4(256, 512, 256, 128)             # 22
        self.down23 = ADown(512, 512)                              # 23 P4/16
        self.fuse24 = CBFuse([3, 3])                               # 24
        self.elan25 = RepNCSPELAN4(512, 1024, 512, 256)            # 25
        self.down26 = ADown(1024, 1024)                            # 26 P5/32
        self.fuse27 = CBFuse([4])                                  # 27
        self.elan28 = RepNCSPELAN4(1024, 1024, 512, 256)           # 28
        self.spp29 = SPPELAN(1024, 512, 256)                       # 29
        self.elan32 = RepNCSPELAN4(1536, 512, 512, 256)            # 30-32
        self.elan35 = RepNCSPELAN4(1024, 256, 256, 128)            # 33-35 P3 out
        self.down36 = ADown(256, 256)                              # 36
        self.elan38 = RepNCSPELAN4(768, 512, 512, 256)             # 37-38 P4 out
        self.down39 = ADown(512, 512)                              # 39
        self.elan41 = RepNCSPELAN4(1024, 512, 1024, 512)           # 40-41 P5 out
        self.head = Head(nc, reg_max)                              # 42 Detect

    def forward(self, x):
        y = self.conv1(x)
        cb = [self.cbl10(y)]
        y = self.elan3(self.conv2(y))
        cb.append(self.cbl11(y))
        y = self.elan5(self.down4(y))
        cb.append(self.cbl12(y))
        y = self.elan7(self.down6(y))
        cb.append(self.cbl13(y))
        cb.append(self.cbl14(self.elan9(self.down8(y))))
        del y
        y = self.fuse16([*cb, self.conv15(x)])
        y = self.fuse18([*cb[1:], self.conv17(y)])
        b3 = self.elan22(self.fuse21([*cb[2:], self.down20(self.elan19(y))]))
        b4 = self.elan25(self.fuse24([*cb[3:], self.down23(b3)]))
        b5 = self.spp29(self.elan28(self.fuse27([*cb[4:], self.down26(b4)])))
        del cb, y
        h4 = self.elan32(torch.cat([upsample2x(b5), b4], 1))
        n3 = self.elan35(torch.cat([upsample2x(h4), b3], 1))
        n4 = self.elan38(torch.cat([self.down36(n3), h4], 1))
        n5 = self.elan41(torch.cat([self.down39(n4), b5], 1))
        return self.head((n3, n4, n5))


def build(spec: dict) -> nn.Module:
    return YoloV9E(spec["num_classes"], spec["reg_max"])
