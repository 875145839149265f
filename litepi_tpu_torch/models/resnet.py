"""ResNet-18 (torchvision's architecture), a second-stage classifier, and
the ResNet-50 feature extractor of the Faster R-CNN baseline, NCHW.

Mirrors the JAX package's ``models/resnet.py``: a 7x7/2 ``conv1`` with its
``bn1`` (eps 1e-5; folded as a ``conv1``/``bn1`` pair), a 3x3/2 max-pool,
four stages of two BasicBlocks (``layer1_0.cb1``, ..., ``layer2_0.down``),
a global mean and a float32 ``fc``.  In bf16 the deploy form adds each
conv's bias after the conv's own rounding, as the JAX model's biased bf16
convs round (``layers.py::conv_bias_apart``).

:class:`ResNet50Backbone` (stages of :class:`BottleneckBlock`, ``cb1`` /
``cb2`` / ``cb3`` / ``down``) returns C2..C5 and is never folded.  Its
BatchNorm normalises as flax's ``nn.BatchNorm(dtype=...)`` does in both
modes: statistics and the normalisation in float32, the output in the
activations' dtype (:func:`~litepi_tpu_torch.models.layers.batch_norm_flax`;
torch's eval-mode BatchNorm folds its scale and shift first and rounds
otherwise).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from litepi_tpu_torch.models.layers import (
    CLASSIFIER_BN,
    ConvBN,
    at_least_float32,
    batch_norm_flax,
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


class _ConvBN(nn.Module):
    """The JAX ``_ConvBN`` of the bottleneck: a bias-free conv (padding
    ``kernel // 2``) and a BatchNorm (eps 1e-5, flax momentum 0.9)."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1) -> None:
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride, kernel // 2, bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm_flax(self.bn, self.conv(x), self.training)


class BottleneckBlock(nn.Module):
    """ResNet v1.5 bottleneck: 1x1 reduce, 3x3 at ``stride``, 1x1 expand to
    ``4 * width``, a 1x1 projection ``down`` where the stride or width
    changes, ReLU after the sum."""

    def __init__(self, c_in: int, width: int, stride: int = 1) -> None:
        super().__init__()
        out_c = 4 * width
        self.cb1 = _ConvBN(c_in, width, 1)
        self.cb2 = _ConvBN(width, width, 3, stride)
        self.cb3 = _ConvBN(width, out_c, 1)
        self.down = _ConvBN(c_in, out_c, 1, stride) if stride != 1 or c_in != out_c else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.down is None else self.down(x)
        y = F.relu(self.cb2(F.relu(self.cb1(x))))
        return F.relu(self.cb3(y) + identity)


class ResNet50Backbone(nn.Module):
    """ResNet-50 feature extractor: (B, 3, S, S) -> (C2, C3, C4, C5) at
    strides 4 / 8 / 16 / 32 with 256 / 512 / 1024 / 2048 channels.  The
    activations take the dtype of the input and of the conv weights
    (``train/detector.py::forward_in`` casts both for a bf16 forward)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3)) -> None:
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5, momentum=0.1)
        c_in = 64
        for stage, blocks in enumerate(self.stage_sizes):
            width = 64 * 2 ** stage
            for i in range(blocks):
                stride = 2 if stage > 0 and i == 0 else 1
                setattr(self, f"layer{stage + 1}_{i}", BottleneckBlock(c_in, width, stride))
                c_in = 4 * width

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.conv1(x.to(self.conv1.weight.dtype))
        x = F.relu(batch_norm_flax(self.bn1, x, self.training))
        x = F.max_pool2d(x, 3, 2, 1)  # pads with -inf, as flax's max_pool
        feats = []
        for stage, blocks in enumerate(self.stage_sizes):
            for i in range(blocks):
                x = getattr(self, f"layer{stage + 1}_{i}")(x)
            feats.append(x)
        return tuple(feats)
