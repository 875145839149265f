"""Reference ResNet-18 classifier (He et al., arXiv:1512.03385; torchvision
``resnet18``'s layout), plain float32, BatchNorm unfolded (eps 1e-5).
Input (N, 3, S, S) normalised RGB crops, output (N, num_classes) logits."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from cardbench.reference.layers import ConvBN

EPS = 1e-5


class BasicBlock(nn.Module):
    def __init__(self, c_in, c_out, stride=1):
        super().__init__()
        self.cb1 = ConvBN(c_in, c_out, 3, stride, act="relu", bn_eps=EPS)
        self.cb2 = ConvBN(c_out, c_out, 3, 1, act=None, bn_eps=EPS)
        self.down = (ConvBN(c_in, c_out, 1, stride, act=None, bn_eps=EPS)
                     if stride != 1 or c_in != c_out else None)

    def forward(self, x):
        identity = x if self.down is None else self.down(x)
        return F.relu(self.cb2(self.cb1(x)) + identity)


class ResNet18(nn.Module):
    def __init__(self, spec: dict):
        super().__init__()
        self.stage_sizes = tuple(spec["stage_sizes"])
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=EPS)
        c_in = 64
        for stage, blocks in enumerate(self.stage_sizes):
            c_out = 64 * 2 ** stage
            for i in range(blocks):
                stride = 2 if stage > 0 and i == 0 else 1
                setattr(self, f"layer{stage + 1}_{i}", BasicBlock(c_in, c_out, stride))
                c_in = c_out
        self.fc = nn.Linear(c_in, spec["num_classes"])

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for stage, blocks in enumerate(self.stage_sizes):
            for i in range(blocks):
                x = getattr(self, f"layer{stage + 1}_{i}")(x)
        return self.fc(x.mean(dim=(2, 3)))


def build(spec: dict) -> nn.Module:
    return ResNet18(spec)
