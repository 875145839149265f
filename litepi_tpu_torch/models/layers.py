"""Building blocks of the detector family, as PyTorch modules (NCHW).

Conventions of the JAX package kept for weight parity: convs pad
symmetrically by ``k // 2`` unless told otherwise, the detectors' BatchNorm
uses eps 1e-3 (momentum 0.03) and SiLU, the classifiers' torchvision's eps
1e-5 (``CLASSIFIER_BN_EPS``).  Submodule names follow the Flax names
(``conv``, ``bn``, ``cv1``, ``m0``, ...) so that ``weights/jax_bridge.py``
maps a Flax variable tree onto a ``state_dict`` key by key.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


# all four reference classifiers use torchvision's BatchNorm2d epsilon
CLASSIFIER_BN_EPS = 1e-5


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


_ACTS = {
    None: _identity,
    "relu": F.relu,
    "relu6": F.relu6,
    "silu": F.silu,
}


class ConvBN(nn.Module):
    """Conv2d + BatchNorm (eps ``bn_eps``) + ``act`` (``"silu"``,
    ``"relu"``, ``"relu6"`` or None).  ``fused=True`` is the deploy form: a
    biased conv with BN folded in (``weights/fold_bn.py``).  ``padding`` -1
    pads by ``kernel // 2``; 0 or more pads by that much (YOLOv5's 6x6/2
    stem pads by 2)."""

    def __init__(
        self,
        c_in: int,
        c_out: int,
        kernel: int = 1,
        stride: int = 1,
        groups: int = 1,
        act: Optional[str] = "silu",
        fused: bool = False,
        bn_eps: float = 1e-3,
        padding: int = -1,
    ) -> None:
        super().__init__()
        pad = kernel // 2 if padding < 0 else padding
        self.conv = nn.Conv2d(
            c_in, c_out, kernel, stride, pad, groups=groups, bias=fused
        )
        self.bn = None if fused else nn.BatchNorm2d(c_out, eps=bn_eps, momentum=0.03)
        self.act = _ACTS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return self.act(x)


class Bottleneck(nn.Module):
    """Two 3x3 ConvBN with optional residual (YOLOv8 C2f inner block)."""

    def __init__(self, c: int, shortcut: bool = True, fused: bool = False) -> None:
        super().__init__()
        self.cv1 = ConvBN(c, c, 3, fused=fused)
        self.cv2 = ConvBN(c, c, 3, fused=fused)
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C2f(nn.Module):
    """Cross-stage partial block: 1x1 projection split in two channel
    halves, ``n`` bottlenecks on the second half appending every
    intermediate, concat, 1x1 fuse."""

    def __init__(
        self, c_in: int, c_out: int, n: int = 1, shortcut: bool = False,
        fused: bool = False,
    ) -> None:
        super().__init__()
        self.hidden = c_out // 2
        self.n = n
        self.cv1 = ConvBN(c_in, 2 * self.hidden, 1, fused=fused)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(self.hidden, shortcut, fused))
        self.cv2 = ConvBN((2 + n) * self.hidden, c_out, 1, fused=fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x).chunk(2, dim=1)
        outs = [a, b]
        for i in range(self.n):
            b = getattr(self, f"m{i}")(b)
            outs.append(b)
        return self.cv2(torch.cat(outs, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): three chained 5x5 stride-1 max-pools."""

    def __init__(self, c_in: int, c_out: int, pool: int = 5, fused: bool = False) -> None:
        super().__init__()
        hidden = c_in // 2
        self.pool = pool
        self.cv1 = ConvBN(c_in, hidden, 1, fused=fused)
        self.cv2 = ConvBN(4 * hidden, c_out, 1, fused=fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pools = [self.cv1(x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], self.pool, 1, self.pool // 2))
        return self.cv2(torch.cat(pools, dim=1))


def flatten_anchors(x: torch.Tensor) -> torch.Tensor:
    """A head's (B, C, H, W) output -> (B, H*W, C), anchors row-major (y, x)
    as the JAX head flattens NHWC (an NCHW reshape would reorder them)."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (the PAN top-down path's Upsample)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
