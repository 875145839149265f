"""Reference ShuffleNetV2 1.0x classifier (Ma et al., arXiv:1807.11164;
torchvision's ``shufflenet_v2_x1_0`` layout), plain float32, BatchNorm
unfolded (eps 1e-5).  Input (N, 3, S, S) normalised RGB crops, output
(N, num_classes) logits."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cardbench.reference.layers import ConvBN

EPS = 1e-5


def channel_shuffle(x, groups=2):
    b, c, h, w = x.shape
    return x.view(b, groups, c // groups, h, w).transpose(1, 2).reshape(b, c, h, w)


class Unit(nn.Module):
    def __init__(self, c_in, c_out, stride):
        super().__init__()
        half = c_out // 2
        self.stride = stride
        b2_in = c_in if stride != 1 else c_in // 2
        self.b2_pw1 = ConvBN(b2_in, half, 1, act="relu", bn_eps=EPS)
        self.b2_dw = ConvBN(half, half, 3, stride, half, act=None, bn_eps=EPS)
        self.b2_pw2 = ConvBN(half, half, 1, act="relu", bn_eps=EPS)
        if stride != 1:
            self.b1_dw = ConvBN(c_in, c_in, 3, stride, c_in, act=None, bn_eps=EPS)
            self.b1_pw = ConvBN(c_in, half, 1, act="relu", bn_eps=EPS)

    def forward(self, x):
        if self.stride == 1:
            a, b = x.chunk(2, dim=1)
            out = torch.cat([a, self.b2_pw2(self.b2_dw(self.b2_pw1(b)))], dim=1)
        else:
            out = torch.cat([self.b1_pw(self.b1_dw(x)),
                             self.b2_pw2(self.b2_dw(self.b2_pw1(x)))], dim=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(nn.Module):
    def __init__(self, spec: dict):
        super().__init__()
        reps, ch = spec["stage_repeats"], spec["stage_channels"]
        self.stage_repeats = tuple(reps)
        self.conv1 = ConvBN(3, ch[0], 3, 2, act="relu", bn_eps=EPS)
        c_in = ch[0]
        for s, (r, c) in enumerate(zip(reps, ch[1:4]), start=2):
            setattr(self, f"stage{s}_0", Unit(c_in, c, 2))
            for i in range(1, r):
                setattr(self, f"stage{s}_{i}", Unit(c, c, 1))
            c_in = c
        self.conv5 = ConvBN(c_in, ch[4], 1, act="relu", bn_eps=EPS)
        self.fc = nn.Linear(ch[4], spec["num_classes"])

    def forward(self, x):
        x = F.max_pool2d(self.conv1(x), 3, 2, 1)
        for s, r in enumerate(self.stage_repeats, start=2):
            for i in range(r):
                x = getattr(self, f"stage{s}_{i}")(x)
        return self.fc(self.conv5(x).mean(dim=(2, 3)))


def build(spec: dict) -> nn.Module:
    return ShuffleNetV2(spec)
