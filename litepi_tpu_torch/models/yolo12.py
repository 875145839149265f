"""YOLO12-L (Ultralytics ``ultralytics/cfg/models/12/yolo12.yaml``, scale l:
depth 1.0, width 1.0, max_channels 512; Tian, Ye, Doermann, "YOLOv12:
Attention-Centric Real-Time Object Detectors", arXiv:2502.12524), on
(B, C, H, W) tensors.

The backbone's P4 and P5 stages are R-ELAN blocks (:class:`A2C2f`) of area
attention blocks (:class:`ABlock`): the P4 tokens attend within four
contiguous chunks of the row-major token order (horizontal strips), the P5
tokens globally, each head 32 channels wide; each block's output is added
back scaled by a learned per-channel ``gamma``.  The neck's A2C2f blocks
hold C3k blocks instead; the stem and the P2 / P3 stages are v11's C3k2
with C3k inner blocks and grouped strided convs; the head is v11's
(:func:`~litepi_tpu_torch.models.yolov11.add_detect_head`).  The output
contract is YoloLitePi's: ``reg`` (B, A, 4*reg_max), ``cls`` (B, A, nc) in
float32.  BatchNorm stays in the module (eps 1e-3); the pipeline runs it
unfolded, as it runs every injected detector.

The model runs channels last from its input on, so that the qkv conv's
output is (B, H, W, 3C) in memory and an area's q, k and v are views of it:
the attention core copies only v, for the positional conv.  ``forward``
makes its input so on every device; on the card that is a no-op, since the
pipeline hands every detector a dense channels-last input.  On the card in
bf16 the core is SDPA's flash kernel and nothing else (a call it cannot
take raises); elsewhere the plain version (:func:`attend_plain`).
Submodule names are the plain reference's (``cardbench/reference/yolo12.py``):
one raw state dict loads into both.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from litepi_tpu_torch.core.metrics import span
from litepi_tpu_torch.kernels import LAUNCHES
from litepi_tpu_torch.models.layers import ConvBN, upsample2x_nearest
from litepi_tpu_torch.models.yolov11 import C3k, C3k2, add_detect_head, detect_head

HEAD_DIM = 32  # every ABlock's heads, dim // 32 of them
MLP_RATIO = 1.2  # scale l's ABlock MLP width, int(dim * 1.2)


def attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (..., n, d) tensors, the scores and
    the softmax in float32 (at least), the weights cast to v's dtype."""
    scores = torch.matmul(q.float(), k.float().transpose(-2, -1)) * q.shape[-1] ** -0.5
    return torch.matmul(torch.softmax(scores, dim=-1).to(v.dtype), v)


def attend_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """SDPA with only its flash backend allowed: raises where the flash
    kernel cannot take the call, never computes it another way."""
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return F.scaled_dot_product_attention(q, k, v)


def area_attention(qkv: torch.Tensor, num_heads: int, area: int) -> Tuple[torch.Tensor, ...]:
    """The attention core of :class:`AAttn`.  ``qkv`` (B, 3C, H, W), its
    channels head-major (head h's 96 channels are its q, k and v, 32
    each); the H*W tokens row-major, cut into ``area`` contiguous chunks
    that attend within themselves.  Returns the attention output and v,
    each (B, C, H, W) with channels (head, d), channels last in memory.
    Counts the call in ``LAUNCHES["area_attn"]``."""
    b, c3, h, w = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    # (B * area, n, heads, 3 * hd): a view where qkv is channels last
    t = qkv.permute(0, 2, 3, 1).reshape(b * area, h * w // area, num_heads, 3 * hd)
    q, k, v = t.split(hd, dim=-1)
    attend = attend_flash if qkv.is_cuda and qkv.dtype == torch.bfloat16 else attend_plain
    o = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    LAUNCHES["area_attn"] += 1
    o = o.transpose(1, 2).reshape(b, h, w, c).permute(0, 3, 1, 2)
    v = v.reshape(b, h, w, c).permute(0, 3, 1, 2)  # the one copy: v's channels gathered
    return o, v


class AAttn(nn.Module):
    """Area attention: a 1x1 qkv conv (no activation), the attention core
    under the ``litepi.attn`` span, a depthwise 7x7 positional conv on v
    added to its output, a 1x1 projection (no activation)."""

    def __init__(self, dim: int, num_heads: int, area: int = 1) -> None:
        super().__init__()
        self.num_heads, self.area = num_heads, area
        self.qkv = ConvBN(dim, 3 * dim, 1, act=None)
        self.proj = ConvBN(dim, dim, 1, act=None)
        self.pe = ConvBN(dim, dim, 7, groups=dim, act=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = self.qkv(x)
        with span("attn"):
            o, v = area_attention(qkv, self.num_heads, self.area)
        return self.proj(o + self.pe(v))


class ABlock(nn.Module):
    """``x + attn(x)``, then ``x + mlp(x)`` with a 1x1 MLP of width
    ``int(dim * 1.2)`` (SiLU, then no activation); the whole block under
    the ``litepi.ablock`` span."""

    def __init__(self, dim: int, num_heads: int, area: int = 1) -> None:
        super().__init__()
        hidden = int(dim * MLP_RATIO)
        self.attn = AAttn(dim, num_heads, area)
        self.mlp = nn.Sequential(ConvBN(dim, hidden, 1), ConvBN(hidden, dim, 1, act=None))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("ablock"):
            x = x + self.attn(x)
            return x + self.mlp(x)


class A2C2f(nn.Module):
    """R-ELAN as scale l builds it (``residual=True``, ``mlp_ratio=1.2``,
    ``e=0.5``): ``y0 = cv1(x)`` (width ``c_out // 2``), ``y_i =
    m_i(y_{i-1})`` with each ``m_i`` two ABlocks (``a2``) or a C3k, ``out =
    cv2(cat(y0..yn))``; with ``a2``, ``x + gamma * out`` (``gamma``
    (c_out,), published init 0.01)."""

    def __init__(self, c_in: int, c_out: int, n: int = 1, a2: bool = True, area: int = 1) -> None:
        super().__init__()
        hidden = c_out // 2
        self.n = n
        self.cv1 = ConvBN(c_in, hidden, 1)
        self.cv2 = ConvBN((1 + n) * hidden, c_out, 1)
        self.gamma = nn.Parameter(torch.full((c_out,), 0.01)) if a2 else None
        for i in range(n):
            block = (nn.Sequential(*(ABlock(hidden, hidden // HEAD_DIM, area) for _ in range(2)))
                     if a2 else C3k(hidden, hidden))
            setattr(self, f"m{i}", block)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = [self.cv1(x)]
        for i in range(self.n):
            ys.append(getattr(self, f"m{i}")(ys[-1]))
        out = self.cv2(torch.cat(ys, dim=1))
        if self.gamma is None:
            return out
        return torch.addcmul(x, self.gamma.view(1, -1, 1, 1), out)


class Yolo12L(nn.Module):
    """YOLO12 at scale l.  Input (B, 3, S, S) in the weights' dtype, scaled
    to [0, 1], RGB; S a multiple of 32 whose P4 grid splits into four
    equal token chunks."""

    def __init__(self, num_classes: int = 1, reg_max: int = 16) -> None:
        super().__init__()
        self.stem = ConvBN(3, 64, 3, 2)
        self.down1 = ConvBN(64, 128, 3, 2, groups=2)
        self.c3k2_1 = C3k2(128, 256, 2, True, 0.25)
        self.down2 = ConvBN(256, 256, 3, 2, groups=4)
        self.c3k2_2 = C3k2(256, 512, 2, True, 0.25)
        self.down3 = ConvBN(512, 512, 3, 2)
        self.a2c2f_p4 = A2C2f(512, 512, 4, True, 4)
        self.down4 = ConvBN(512, 512, 3, 2)
        self.a2c2f_p5 = A2C2f(512, 512, 4, True, 1)
        self.td_p4 = A2C2f(1024, 512, 2, False)
        self.td_p3 = A2C2f(1024, 256, 2, False)
        self.bu_down3 = ConvBN(256, 256, 3, 2)
        self.bu_p4 = A2C2f(768, 512, 2, False)
        self.bu_down4 = ConvBN(512, 512, 3, 2)
        self.bu_p5 = C3k2(1024, 512, 2, True)
        add_detect_head(self, (256, 512, 512), num_classes, reg_max)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.contiguous(memory_format=torch.channels_last)
        p3 = self.c3k2_2(self.down2(self.c3k2_1(self.down1(self.stem(x)))))
        p4 = self.a2c2f_p4(self.down3(p3))
        p5 = self.a2c2f_p5(self.down4(p4))
        t4 = self.td_p4(torch.cat([upsample2x_nearest(p5), p4], dim=1))
        n3 = self.td_p3(torch.cat([upsample2x_nearest(t4), p3], dim=1))
        n4 = self.bu_p4(torch.cat([self.bu_down3(n3), t4], dim=1))
        n5 = self.bu_p5(torch.cat([self.bu_down4(n4), p5], dim=1))
        return detect_head(self, (n3, n4, n5))
