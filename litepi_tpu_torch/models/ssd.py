"""SSD300-VGG16, the reference's one-stage baseline, NCHW.

The port's copy of the JAX package's ``models/ssd.py``: the VGG16 body
(conv1_1..conv5_3, a ceil-mode pool3 that pads bottom / right with the
edge, pool5 3x3/1), a dilated (6) conv6 and a 1x1 conv7, the extra layers
conv8..conv11, ``L2Norm`` (scale 20) on conv4_3, and per-level ``loc{i}``
(4 per box) and ``conf{i}`` (nc + 1 per box, background 0) heads over the
8,732-box default grid (38/19/10/5/3/1 with 4/6/6/6/4/4 boxes per cell).

Its "bf16" is the JAX model's: ``SSD300(dtype=bf16)`` rounds its input to
bf16 once, but its convs carry no ``dtype``, so flax promotes each of them
to float32 from its float32 parameters and the network computes in float32
after that one rounding.  The port reproduces that and is not a bf16
network (``tests/test_torch_ssd.py`` shows the JAX behaviour).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class L2Norm(nn.Module):
    """Channelwise L2 normalisation with a learned per-channel ``weight``
    (the Flax ``scale``), the square root taken in float32 with 1e-10
    inside it."""

    def __init__(self, channels: int, init_scale: float = 20.0) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), init_scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt(torch.sum(x.float() ** 2, dim=1, keepdim=True) + 1e-10)
        return (x / norm.to(x.dtype)) * self.weight.to(x.dtype)[:, None, None]


# feature-map sizes and boxes per cell for a 300x300 input
SSD_GRIDS = (38, 19, 10, 5, 3, 1)
SSD_BOXES_PER_CELL = (4, 6, 6, 6, 4, 4)
NUM_SSD_BOXES = sum(g * g * b for g, b in zip(SSD_GRIDS, SSD_BOXES_PER_CELL))  # 8732


def ssd_default_boxes(image_size: int = 300) -> np.ndarray:
    """The SSD300 default-box grid -> (8732, 4) float32 cxcywh pixels:
    scale 0.07 on conv4_3, then 0.15..0.87 (and 1.05 for the last extra
    box); ratios {1, 2, 1/2} (+{3, 1/3} on the 6-box maps) plus the
    sqrt(s_k s_{k+1}) square box; clipped to [0, 1] before scaling."""
    scales = [0.07, 0.15, 0.33, 0.51, 0.69, 0.87, 1.05]
    boxes: List[List[float]] = []
    for level, (g, nb) in enumerate(zip(SSD_GRIDS, SSD_BOXES_PER_CELL)):
        s, s_next = scales[level], scales[level + 1]
        ratios = [1.0, 2.0, 0.5] if nb == 4 else [1.0, 2.0, 0.5, 3.0, 1.0 / 3.0]
        for y in range(g):
            for x in range(g):
                cx, cy = (x + 0.5) / g, (y + 0.5) / g
                for r in ratios:
                    boxes.append([cx, cy, s * np.sqrt(r), s / np.sqrt(r)])
                sp = np.sqrt(s * s_next)
                boxes.append([cx, cy, sp, sp])
    out = np.asarray(boxes, np.float32)
    if out.shape[0] != NUM_SSD_BOXES:
        raise AssertionError(f"default grid has {out.shape[0]} boxes")
    return np.clip(out, 0.0, 1.0) * image_size


def _conv(c_in: int, c_out: int, k: int, dilation: int = 1, stride: int = 1,
          padding=None) -> nn.Conv2d:
    pad = (k // 2) * dilation if padding is None else padding
    return nn.Conv2d(c_in, c_out, k, stride, pad, dilation=dilation)


# VGG16 blocks: (name, widths)
_VGG = (("conv1", (64, 64)), ("conv2", (128, 128)), ("conv3", (256, 256, 256)),
        ("conv4", (512, 512, 512)), ("conv5", (512, 512, 512)))
# extra layers: (name, c_in, c_out, kernel, stride, padding)
_EXTRA = (("conv8_1", 1024, 256, 1, 1, None), ("conv8_2", 256, 512, 3, 2, None),
          ("conv9_1", 512, 128, 1, 1, None), ("conv9_2", 128, 256, 3, 2, None),
          ("conv10_1", 256, 128, 1, 1, None), ("conv10_2", 128, 256, 3, 1, 0),
          ("conv11_1", 256, 128, 1, 1, None), ("conv11_2", 128, 256, 3, 1, 0))
_FEATURE_CHANNELS = (512, 1024, 512, 256, 256, 256)


class SSD300(nn.Module):
    """Input (B, 3, 300, 300) in [0, 1] RGB; returns ``loc`` (B, 8732, 4)
    offsets and ``conf`` (B, 8732, nc + 1) logits, float32.  ``dtype`` is
    the one rounding of the input (see the module docstring)."""

    def __init__(self, num_classes: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        c_in = 3
        for name, widths in _VGG:
            for i, c in enumerate(widths):
                setattr(self, f"{name}_{i + 1}", _conv(c_in, c, 3))
                c_in = c
        self.conv6 = _conv(512, 1024, 3, dilation=6)
        self.conv7 = _conv(1024, 1024, 1)
        for name, ci, co, k, stride, pad in _EXTRA:
            setattr(self, name, _conv(ci, co, k, stride=stride, padding=pad))
        self.l2norm = L2Norm(512)
        nc1 = num_classes + 1
        for i, (c, nb) in enumerate(zip(_FEATURE_CHANNELS, SSD_BOXES_PER_CELL)):
            setattr(self, f"loc{i}", _conv(c, nb * 4, 3))
            setattr(self, f"conf{i}", _conv(c, nb * nc1, 3))
        self.register_buffer("default_boxes", torch.from_numpy(ssd_default_boxes(300)),
                             persistent=False)

    def _block(self, x: torch.Tensor, name: str, n: int, pool: bool = True,
               ceil: bool = False) -> torch.Tensor:
        for i in range(n):
            x = F.relu(getattr(self, f"{name}_{i + 1}")(x))
        if pool:
            if ceil and x.shape[2] % 2:  # ceil-mode pool: pad bottom / right
                x = F.pad(x, (0, 1, 0, 1), mode="replicate")
            x = F.max_pool2d(x, 2, 2)
        return x

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        # one rounding to ``dtype``, then the convs' own precision (float32,
        # as the JAX model's)
        x = x.to(self.dtype).to(self.conv1_1.weight.dtype)
        x = self._block(x, "conv1", 2)  # 150
        x = self._block(x, "conv2", 2)  # 75
        x = self._block(x, "conv3", 3, ceil=True)  # 38
        c4 = self._block(x, "conv4", 3, pool=False)
        x = F.max_pool2d(c4, 2, 2)  # 19
        x = self._block(x, "conv5", 3, pool=False)
        x = F.max_pool2d(x, 3, 1, 1)  # pads with -inf, as flax's max_pool
        x = F.relu(self.conv6(x))
        c7 = F.relu(self.conv7(x))
        c8 = F.relu(self.conv8_2(F.relu(self.conv8_1(c7))))  # 10
        c9 = F.relu(self.conv9_2(F.relu(self.conv9_1(c8))))  # 5
        c10 = F.relu(self.conv10_2(F.relu(self.conv10_1(c9))))  # 3
        c11 = F.relu(self.conv11_2(F.relu(self.conv11_1(c10))))  # 1
        feats = [self.l2norm(c4), c7, c8, c9, c10, c11]
        locs, confs = [], []
        nc1 = self.num_classes + 1
        for i, f in enumerate(feats):
            b = f.shape[0]
            locs.append(getattr(self, f"loc{i}")(f).permute(0, 2, 3, 1).reshape(b, -1, 4))
            confs.append(getattr(self, f"conf{i}")(f).permute(0, 2, 3, 1).reshape(b, -1, nc1))
        return {"loc": torch.cat(locs, 1).float(), "conf": torch.cat(confs, 1).float()}


def decode_ssd_boxes(
    loc: torch.Tensor,
    default_boxes: torch.Tensor,
    variances: Tuple[float, float] = (0.1, 0.2),
) -> torch.Tensor:
    """SSD decode: offsets (..., N, 4) on cxcywh default boxes (N, 4) ->
    xyxy pixels."""
    d_cx, d_cy, d_w, d_h = (default_boxes[..., i] for i in range(4))
    cx = loc[..., 0] * variances[0] * d_w + d_cx
    cy = loc[..., 1] * variances[0] * d_h + d_cy
    w = torch.exp(torch.clamp(loc[..., 2] * variances[1], -10, 10)) * d_w
    h = torch.exp(torch.clamp(loc[..., 3] * variances[1], -10, 10)) * d_h
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
