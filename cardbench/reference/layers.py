"""Plain float32 building blocks of the reference models (NCHW, eval mode).

Frozen copies of the published blocks, written with plain ``torch.nn``
modules and with the parameter names of the program's modules (``conv``,
``bn``, ``cv1``, ``m0``, ...), so that one raw state dict, BatchNorm
unfolded, loads into both.  BatchNorm runs as ``nn.BatchNorm2d`` in eval
mode: the reference never folds it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

ACTS = {None: lambda x: x, "silu": F.silu, "relu": F.relu}


class ConvBN(nn.Module):
    """Bias-free conv (padding ``kernel // 2`` unless given), BatchNorm
    (eps ``bn_eps``), activation."""

    def __init__(self, c_in, c_out, kernel=1, stride=1, groups=1, act="silu",
                 bn_eps=1e-3, padding=-1):
        super().__init__()
        pad = kernel // 2 if padding < 0 else padding
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride, pad, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=bn_eps)
        self.act = ACTS[act]

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    """Two 3x3 ConvBN, residual when ``shortcut``."""

    def __init__(self, c, shortcut=True):
        super().__init__()
        self.cv1 = ConvBN(c, c, 3)
        self.cv2 = ConvBN(c, c, 3)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C2f(nn.Module):
    """YOLOv8's C2f: 1x1 to two halves, ``n`` bottlenecks on the second
    half keeping every output, concat, 1x1."""

    def __init__(self, c_in, c_out, n=1, shortcut=False):
        super().__init__()
        self.hidden, self.n = c_out // 2, n
        self.cv1 = ConvBN(c_in, 2 * self.hidden, 1)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(self.hidden, shortcut))
        self.cv2 = ConvBN((2 + n) * self.hidden, c_out, 1)

    def forward(self, x):
        a, b = self.cv1(x).chunk(2, dim=1)
        outs = [a, b]
        for i in range(self.n):
            b = getattr(self, f"m{i}")(b)
            outs.append(b)
        return self.cv2(torch.cat(outs, dim=1))


class SPPF(nn.Module):
    """Three chained 5x5 stride-1 max-pools between two 1x1 ConvBN."""

    def __init__(self, c_in, c_out, pool=5):
        super().__init__()
        hidden = c_in // 2
        self.pool = pool
        self.cv1 = ConvBN(c_in, hidden, 1)
        self.cv2 = ConvBN(4 * hidden, c_out, 1)

    def forward(self, x):
        pools = [self.cv1(x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], self.pool, 1, self.pool // 2))
        return self.cv2(torch.cat(pools, dim=1))


def flatten_anchors(x):
    """(B, C, H, W) -> (B, H*W, C), anchors row-major over (y, x)."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])


def upsample2x(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def make_divisible(x, divisor=8):
    """Round a channel count up to a multiple of ``divisor``."""
    return int(math.ceil(x / divisor) * divisor)


def scale_depth(n, depth):
    return max(round(n * depth), 1)
