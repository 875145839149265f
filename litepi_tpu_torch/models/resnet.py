"""ResNet-18 (torchvision's architecture), a second-stage classifier, NCHW.

Mirrors the JAX package's ``models/resnet.py``: a 7x7/2 ``conv1`` with its
``bn1`` (eps 1e-5; folded as a ``conv1``/``bn1`` pair), a 3x3/2 max-pool,
four stages of two BasicBlocks (``layer1_0.cb1``, ..., ``layer2_0.down``),
a global mean and a float32 ``fc``.  In bf16 the deploy form adds each
conv's bias after the conv's own rounding, as the JAX model's biased bf16
convs round (``layers.py::conv_bias_apart``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from litepi_tpu_torch.models.layers import (
    CLASSIFIER_BN,
    ConvBN,
    at_least_float32,
    batch_norm_train,
    conv_bias_apart,
)


class BasicBlock(nn.Module):
    """Two 3x3 conv-BNs (ReLU between), a 1x1 projection ``down`` where the
    stride or width changes, ReLU after the sum."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1, fused: bool = False) -> None:
        super().__init__()
        kw = dict(fused=fused, bias_apart=True, **CLASSIFIER_BN)
        self.cb1 = ConvBN(c_in, c_out, 3, stride, act="relu", **kw)
        self.cb2 = ConvBN(c_out, c_out, 3, 1, act=None, **kw)
        self.down = (
            ConvBN(c_in, c_out, 1, stride, act=None, **kw)
            if stride != 1 or c_in != c_out else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.down is None else self.down(x)
        return F.relu(self.cb2(self.cb1(x)) + identity)


class ResNet18(nn.Module):
    """Input (N, 3, S, S) normalised crops; output (N, num_classes) float32
    logits.  A bfloat16 model keeps its ``fc`` in float32."""

    def __init__(
        self, num_classes: int, stage_sizes: Sequence[int] = (2, 2, 2, 2),
        fused: bool = False,
    ) -> None:
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=fused)
        self.bn1 = None if fused else nn.BatchNorm2d(64, eps=1e-5, momentum=0.1)
        c_in = 64
        for stage, blocks in enumerate(self.stage_sizes):
            c_out = 64 * 2 ** stage
            for i in range(blocks):
                stride = 2 if stage > 0 and i == 0 else 1
                setattr(self, f"layer{stage + 1}_{i}", BasicBlock(c_in, c_out, stride, fused))
                c_in = c_out
        self.fc = nn.Linear(c_in, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_bias_apart(self.conv1, x.to(self.conv1.weight.dtype))
        if self.bn1 is not None:
            x = batch_norm_train(self.bn1, x) if self.training else self.bn1(x)
        x = F.max_pool2d(F.relu(x), 3, 2, 1)
        for stage, blocks in enumerate(self.stage_sizes):
            for i in range(blocks):
                x = getattr(self, f"layer{stage + 1}_{i}")(x)
        x = x.mean(dim=(2, 3))
        return at_least_float32(self.fc(x.to(self.fc.weight.dtype)))
