"""MobileNetV2 (torchvision's architecture), a second-stage classifier, NCHW.

Mirrors the JAX package's ``models/mobilenetv2.py``: conv-BN-ReLU6 units
(BN eps 1e-5), inverted residual blocks ``block0``..``block16`` (``pw``,
``dw``, ``pw_linear``), a 1x1 ``head_conv``, a global mean, dropout (the
identity at inference) and a float32 ``fc``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from litepi_tpu_torch.models.layers import CLASSIFIER_BN, ConvBN, Dropout, at_least_float32


def _make_divisible(v: float, divisor: int = 8) -> int:
    """torchvision's channel rounding (to nearest, never below 90%)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class InvertedResidualV2(nn.Module):
    """1x1 expand (when ``expand`` > 1), 3x3 depthwise, 1x1 linear
    projection; residual where stride 1 keeps the width."""

    def __init__(
        self, c_in: int, c_out: int, stride: int, expand: int, fused: bool = False
    ) -> None:
        super().__init__()
        hidden = c_in * expand
        self.pw = (
            ConvBN(c_in, hidden, 1, act="relu6", fused=fused, **CLASSIFIER_BN)
            if expand != 1 else None
        )
        self.dw = ConvBN(
            hidden, hidden, 3, stride, hidden, act="relu6", fused=fused, **CLASSIFIER_BN
        )
        self.pw_linear = ConvBN(hidden, c_out, 1, act=None, fused=fused, **CLASSIFIER_BN)
        self.residual = stride == 1 and c_in == c_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x if self.pw is None else self.pw(x)
        y = self.pw_linear(self.dw(y))
        return x + y if self.residual else y


# (expand t, channels c, repeats n, stride s), the MobileNetV2 paper's table
_V2_SETTINGS: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class MobileNetV2(nn.Module):
    """Input (N, 3, S, S) normalised crops; output (N, num_classes) float32
    logits.  A bfloat16 model keeps its ``fc`` in float32."""

    def __init__(self, num_classes: int, width_mult: float = 1.0, fused: bool = False) -> None:
        super().__init__()
        c_in = _make_divisible(32 * width_mult)
        self.stem = ConvBN(3, c_in, 3, 2, act="relu6", fused=fused, **CLASSIFIER_BN)
        self.n_blocks = 0
        for t, ch, n, s in _V2_SETTINGS:
            c_out = _make_divisible(ch * width_mult)
            for i in range(n):
                block = InvertedResidualV2(c_in, c_out, s if i == 0 else 1, t, fused)
                setattr(self, f"block{self.n_blocks}", block)
                self.n_blocks += 1
                c_in = c_out
        last = _make_divisible(1280 * max(1.0, width_mult))
        self.head_conv = ConvBN(c_in, last, 1, act="relu6", fused=fused, **CLASSIFIER_BN)
        self.dropout = Dropout(0.2)
        self.fc = nn.Linear(last, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x.to(self.stem.conv.weight.dtype))
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        x = self.dropout(self.head_conv(x).mean(dim=(2, 3)))
        return at_least_float32(self.fc(x.to(self.fc.weight.dtype)))
