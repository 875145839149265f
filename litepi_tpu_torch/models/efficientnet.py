"""EfficientNet-B0 (torchvision's architecture), a second-stage classifier,
NCHW.

Mirrors the JAX package's ``models/efficientnet.py``: conv-BN-SiLU units
(BN eps 1e-5), MBConv blocks ``block0``..``block15`` (``pw``, ``dw``,
squeeze-excite ``se.fc1``/``se.fc2``, ``pw_linear``), a 1x1 ``head_conv``
to 1280, a global mean, dropout (the identity at inference) and a float32
``fc``.

In bf16 it rounds as the JAX program: SiLU and the squeeze-excite sigmoid
at each step (``ops/act.py``), and a deploy-form conv's bias added after
its output is rounded (``ConvBN(bias_apart=True)``, as flax's biased bf16
conv): against JAX's own bf16 drift its cls scores went from 1.02x to
0.79x, its probabilities from 0.81x to 0.54x (``python -m
tests.torch_bf16_layers --pairs``; ROADMAP section 3).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from litepi_tpu_torch.models.layers import CLASSIFIER_BN_EPS, ConvBN
from litepi_tpu_torch.ops.act import sigmoid, silu


class SqueezeExcite(nn.Module):
    """Channel gate: global mean -> 1x1 to ``squeeze`` -> SiLU -> 1x1 back
    -> sigmoid, times the input."""

    def __init__(self, c: int, squeeze: int) -> None:
        super().__init__()
        self.fc1 = nn.Conv2d(c, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.fc2(silu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * sigmoid(s)


class MBConv(nn.Module):
    """1x1 expand (when ``expand`` > 1), k x k depthwise, squeeze-excite
    (squeeze width from the block's input: ``c_in // 4``), 1x1 linear
    projection; residual where stride 1 keeps the width (stochastic depth
    is the identity at inference)."""

    def __init__(
        self, c_in: int, c_out: int, kernel: int, stride: int, expand: int,
        fused: bool = False,
    ) -> None:
        super().__init__()
        hidden = c_in * expand
        self.pw = (
            ConvBN(c_in, hidden, 1, act="silu", fused=fused, bn_eps=CLASSIFIER_BN_EPS,
                   bias_apart=True)
            if expand != 1 else None
        )
        self.dw = ConvBN(
            hidden, hidden, kernel, stride, hidden, act="silu", fused=fused,
            bn_eps=CLASSIFIER_BN_EPS, bias_apart=True,
        )
        self.se = SqueezeExcite(hidden, max(1, c_in // 4))
        self.pw_linear = ConvBN(hidden, c_out, 1, act=None, fused=fused, bn_eps=CLASSIFIER_BN_EPS,
                                bias_apart=True)
        self.residual = stride == 1 and c_in == c_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x if self.pw is None else self.pw(x)
        y = self.pw_linear(self.se(self.dw(y)))
        return x + y if self.residual else y


# (expand, channels, repeats, stride, kernel), the EfficientNet-B0 stage table
_B0_SETTINGS: Tuple[Tuple[int, int, int, int, int], ...] = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


class EfficientNetB0(nn.Module):
    """Input (N, 3, S, S) normalised crops; output (N, num_classes) float32
    logits.  A bfloat16 model keeps its ``fc`` in float32."""

    def __init__(self, num_classes: int, fused: bool = False) -> None:
        super().__init__()
        self.stem = ConvBN(3, 32, 3, 2, act="silu", fused=fused, bn_eps=CLASSIFIER_BN_EPS,
                           bias_apart=True)
        c_in, self.n_blocks = 32, 0
        for t, c, n, s, k in _B0_SETTINGS:
            for i in range(n):
                block = MBConv(c_in, c, k, s if i == 0 else 1, t, fused)
                setattr(self, f"block{self.n_blocks}", block)
                self.n_blocks += 1
                c_in = c
        self.head_conv = ConvBN(c_in, 1280, 1, act="silu", fused=fused,
                                bn_eps=CLASSIFIER_BN_EPS, bias_apart=True)
        self.fc = nn.Linear(1280, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x.to(self.stem.conv.weight.dtype))
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        x = self.head_conv(x).mean(dim=(2, 3))
        return self.fc(x.to(self.fc.weight.dtype)).float()
