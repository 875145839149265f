"""The YOLOv11n detector (C3k2 blocks, C2PSA spatial attention,
depthwise-separable class head), NCHW.

Mirrors the JAX package's ``models/yolov11.py`` block for block, with its
Flax submodule names (``stem``, ``c3k2_1.m0.cv1``, ``c2psa.m0.attn.qkv``,
``cls0_dw1``, ...).  The output contract is YoloLitePi's: ``reg`` (B, A,
4*reg_max) and ``cls`` (B, A, nc) in float32, anchors row-major (y, x)
per level, P3..P5.  BatchNorm stays in the module (eps 1e-3); the pipeline
runs it unfolded, as the JAX package runs an injected detector.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from litepi_tpu_torch.core.types import make_divisible, scale_depth
from litepi_tpu_torch.models.layers import (
    SPPF,
    Bottleneck,
    ConvBN,
    flatten_anchors,
    upsample2x_nearest,
)


class _HalfBottleneck(nn.Module):
    """C3k2's plain inner block: 3x3 down to half width, 3x3 back up,
    residual."""

    def __init__(self, c: int, shortcut: bool = True) -> None:
        super().__init__()
        self.cv1 = ConvBN(c, c // 2, 3)
        self.cv2 = ConvBN(c // 2, c, 3)
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C3k(nn.Module):
    """C3 with two full-width 3x3/3x3 bottlenecks (v11's deep-stage inner
    block)."""

    def __init__(self, c_in: int, c_out: int, shortcut: bool = True) -> None:
        super().__init__()
        hidden = c_out // 2
        self.cv1 = ConvBN(c_in, hidden, 1)
        self.m0 = Bottleneck(hidden, shortcut)
        self.m1 = Bottleneck(hidden, shortcut)
        self.cv2 = ConvBN(c_in, hidden, 1)
        self.cv3 = ConvBN(2 * hidden, c_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.m1(self.m0(self.cv1(x)))
        return self.cv3(torch.cat([a, self.cv2(x)], dim=1))


class C3k2(nn.Module):
    """v11's CSP block: a C2f whose ``n`` inner modules are C3k blocks
    (``c3k``) or half-expansion bottlenecks; hidden width ``int(c_out * e)``."""

    def __init__(
        self, c_in: int, c_out: int, n: int = 1, c3k: bool = False,
        e: float = 0.5, shortcut: bool = True,
    ) -> None:
        super().__init__()
        hidden = int(c_out * e)
        self.n = n
        self.cv1 = ConvBN(c_in, 2 * hidden, 1)
        for i in range(n):
            block = C3k(hidden, hidden, shortcut) if c3k else _HalfBottleneck(hidden, shortcut)
            setattr(self, f"m{i}", block)
        self.cv2 = ConvBN((2 + n) * hidden, c_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x).chunk(2, dim=1)
        outs = [a, b]
        for i in range(self.n):
            b = getattr(self, f"m{i}")(b)
            outs.append(b)
        return self.cv2(torch.cat(outs, dim=1))


class SpatialAttention(nn.Module):
    """Multi-head self-attention over the H*W spatial tokens, with a
    depthwise positional-encoding branch on V.

    The qkv channels are branch-major, ``[q all heads | k all heads | v all
    heads]``; q/k heads are ``key_dim = head_dim * attn_ratio`` wide.  The
    scores accumulate and softmax in float32 and the weights are cast to
    v's dtype, as the JAX einsum with ``preferred_element_type=float32``.
    """

    def __init__(self, dim: int, num_heads: int, attn_ratio: float = 0.5) -> None:
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        nh_kd = self.key_dim * num_heads
        self.qkv = ConvBN(dim, dim + 2 * nh_kd, 1, act=None)
        self.pe = ConvBN(dim, dim, 3, groups=dim, act=None)
        self.proj = ConvBN(dim, dim, 1, act=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        nh, kd, hd = self.num_heads, self.key_dim, self.head_dim
        qkv = self.qkv(x)
        # channels (head, d) of each branch; tokens row-major over (h, w)
        q = qkv[:, : nh * kd].reshape(b, nh, kd, h * w)
        k = qkv[:, nh * kd : 2 * nh * kd].reshape(b, nh, kd, h * w)
        v = qkv[:, 2 * nh * kd :]
        scores = torch.matmul(q.transpose(2, 3).float(), k.float()) / math.sqrt(kd)
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        # (B, heads, head_dim, N) = v @ attn^T, regrouped to channels
        y = torch.matmul(v.reshape(b, nh, hd, h * w), attn.transpose(2, 3))
        return self.proj(y.reshape(b, self.dim, h, w) + self.pe(v))


class PSABlock(nn.Module):
    def __init__(self, dim: int, num_heads: int) -> None:
        super().__init__()
        self.attn = SpatialAttention(dim, num_heads)
        self.ffn1 = ConvBN(dim, dim * 2, 1)
        self.ffn2 = ConvBN(dim * 2, dim, 1, act=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x)
        return x + self.ffn2(self.ffn1(x))


class C2PSA(nn.Module):
    """Partial self-attention: 1x1 split in halves, ``n`` PSA blocks (one
    head per 64 channels, at least one) on the second, concat, 1x1."""

    def __init__(self, c_in: int, c_out: int, n: int = 1) -> None:
        super().__init__()
        hidden = c_out // 2
        self.n = n
        self.cv1 = ConvBN(c_in, 2 * hidden, 1)
        for i in range(n):
            setattr(self, f"m{i}", PSABlock(hidden, max(hidden // 64, 1)))
        self.cv2 = ConvBN(2 * hidden, c_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x).chunk(2, dim=1)
        for i in range(self.n):
            b = getattr(self, f"m{i}")(b)
        return self.cv2(torch.cat([a, b], dim=1))


class YoloV11(nn.Module):
    """YOLOv11 detector; the default scales give v11n.  Input (B, 3, S, S)
    in the weights' dtype, scaled to [0, 1], RGB."""

    def __init__(
        self, num_classes: int = 1, width: float = 0.25, depth: float = 0.5,
        reg_max: int = 16,
    ) -> None:
        super().__init__()
        self.num_classes, self.reg_max = num_classes, reg_max
        c = self.channels = tuple(
            make_divisible(ch * width) for ch in (64, 128, 256, 512, 1024)
        )
        n = scale_depth(2, depth)
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

        add_detect_head(self, (c[2], c[3], c[4]), num_classes, reg_max)

    def _features(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.c3k2_1(self.down1(self.stem(x)))
        p3 = self.c3k2_2(self.down2(x))
        p4 = self.c3k2_3(self.down3(p3))
        x = self.sppf(self.c3k2_4(self.down4(p4)))
        p5 = self.c2psa(x)
        t4 = self.td_p4(torch.cat([upsample2x_nearest(p5), p4], dim=1))
        n3 = self.td_p3(torch.cat([upsample2x_nearest(t4), p3], dim=1))
        n4 = self.bu_p4(torch.cat([self.bu_down3(n3), t4], dim=1))
        n5 = self.bu_p5(torch.cat([self.bu_down4(n4), p5], dim=1))
        return n3, n4, n5

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return detect_head(self, self._features(x))


def add_detect_head(
    model: nn.Module, channels: Sequence[int], num_classes: int, reg_max: int
) -> None:
    """Ultralytics' Detect head (v11 and v12) as submodules of ``model``,
    one set per level of ``channels`` (P3..P5): a DFL box branch
    ``reg{i}_cv1``, ``reg{i}_cv2``, ``reg{i}_out`` and a depthwise-separable
    class branch ``cls{i}_dw1``, ``_pw1``, ``_dw2``, ``_pw2``, ``_out``; both
    branches' widths follow from P3's channels."""
    c_reg = max(16, channels[0] // 4, 4 * reg_max)
    c_cls = max(channels[0], min(num_classes, 100))
    for i, f in enumerate(channels):
        setattr(model, f"reg{i}_cv1", ConvBN(f, c_reg, 3))
        setattr(model, f"reg{i}_cv2", ConvBN(c_reg, c_reg, 3))
        setattr(model, f"reg{i}_out", nn.Conv2d(c_reg, 4 * reg_max, 1))
        setattr(model, f"cls{i}_dw1", ConvBN(f, f, 3, groups=f))
        setattr(model, f"cls{i}_pw1", ConvBN(f, c_cls, 1))
        setattr(model, f"cls{i}_dw2", ConvBN(c_cls, c_cls, 3, groups=c_cls))
        setattr(model, f"cls{i}_pw2", ConvBN(c_cls, c_cls, 1))
        setattr(model, f"cls{i}_out", nn.Conv2d(c_cls, num_classes, 1))


def detect_head(model: nn.Module, feats: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The head :func:`add_detect_head` put on ``model``, on its P3..P5
    features: ``reg`` (B, A, 4*reg_max) and ``cls`` (B, A, nc) in float32."""
    reg_out, cls_out = [], []
    for i, f in enumerate(feats):
        r = getattr(model, f"reg{i}_cv2")(getattr(model, f"reg{i}_cv1")(f))
        reg_out.append(flatten_anchors(getattr(model, f"reg{i}_out")(r)))
        k = f
        for name in ("dw1", "pw1", "dw2", "pw2", "out"):
            k = getattr(model, f"cls{i}_{name}")(k)
        cls_out.append(flatten_anchors(k))
    return {
        "reg": torch.cat(reg_out, dim=1).float(),
        "cls": torch.cat(cls_out, dim=1).float(),
    }
