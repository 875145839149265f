"""ShuffleNetV2 (torchvision x1.0 architecture), the second-stage classifier.

Mirrors the JAX package's ``models/shufflenetv2.py`` (BN eps 1e-5, ReLU,
3x3/s2/pad1 max-pool, global mean, float32 ``fc``), NCHW, with the Flax
submodule names (``conv1``, ``stage2_0.b2_dw``, ``fc``, ...).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from litepi_tpu_torch.models.layers import CLASSIFIER_BN, ConvBN, at_least_float32


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """NCHW channel shuffle: out[:, j] = in[:, (j % g) * (c // g) + j // g]."""
    b, c, h, w = x.shape
    return (
        x.view(b, groups, c // groups, h, w).transpose(1, 2).reshape(b, c, h, w)
    )


class InvertedResidual(nn.Module):
    """ShuffleNetV2 unit.  stride 1: split halves, transform one, concat,
    shuffle.  stride 2: two parallel downsampling branches on the input."""

    def __init__(self, c_in: int, c_out: int, stride: int, fused: bool = False) -> None:
        super().__init__()
        half = c_out // 2
        self.stride = stride
        b2_in = c_in if stride != 1 else c_in // 2
        self.b2_pw1 = ConvBN(b2_in, half, 1, act="relu", fused=fused, **CLASSIFIER_BN)
        self.b2_dw = ConvBN(
            half, half, 3, stride, half, act=None, fused=fused, **CLASSIFIER_BN
        )
        self.b2_pw2 = ConvBN(half, half, 1, act="relu", fused=fused, **CLASSIFIER_BN)
        if stride != 1:
            self.b1_dw = ConvBN(
                c_in, c_in, 3, stride, c_in, act=None, fused=fused, **CLASSIFIER_BN
            )
            self.b1_pw = ConvBN(c_in, half, 1, act="relu", fused=fused, **CLASSIFIER_BN)

    def _branch2(self, x: torch.Tensor) -> torch.Tensor:
        return self.b2_pw2(self.b2_dw(self.b2_pw1(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1:
            a, b = x.chunk(2, dim=1)
            out = torch.cat([a, self._branch2(b)], dim=1)
        else:
            out = torch.cat([self.b1_pw(self.b1_dw(x)), self._branch2(x)], dim=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(nn.Module):
    """torchvision-compatible ShuffleNetV2 (x1.0 widths).  Input (N, 3, S, S)
    normalised crops; output (N, num_classes) float32 logits.  A bfloat16
    pipeline keeps the ``fc`` in float32, as the JAX model does."""

    def __init__(
        self,
        num_classes: int,
        stage_repeats: Sequence[int] = (4, 8, 4),
        stage_channels: Sequence[int] = (24, 116, 232, 464, 1024),
        fused: bool = False,
    ) -> None:
        super().__init__()
        self.stage_repeats = tuple(stage_repeats)
        self.conv1 = ConvBN(
            3, stage_channels[0], 3, 2, act="relu", fused=fused, **CLASSIFIER_BN
        )
        c_in = stage_channels[0]
        for s, (reps, ch) in enumerate(
            zip(stage_repeats, stage_channels[1:4]), start=2
        ):
            setattr(self, f"stage{s}_0", InvertedResidual(c_in, ch, 2, fused))
            for i in range(1, reps):
                setattr(self, f"stage{s}_{i}", InvertedResidual(ch, ch, 1, fused))
            c_in = ch
        self.conv5 = ConvBN(
            c_in, stage_channels[4], 1, act="relu", fused=fused, **CLASSIFIER_BN
        )
        self.fc = nn.Linear(stage_channels[4], num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.conv1.conv.weight.dtype)
        x = self.conv1(x)
        x = F.max_pool2d(x, 3, 2, 1)
        for s, reps in enumerate(self.stage_repeats, start=2):
            for i in range(reps):
                x = getattr(self, f"stage{s}_{i}")(x)
        x = self.conv5(x).mean(dim=(2, 3))
        return at_least_float32(self.fc(x.to(self.fc.weight.dtype)))
