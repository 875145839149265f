"""Building blocks of the detector family, as PyTorch modules (NCHW).

Conventions of the JAX package kept for weight parity: convs pad
symmetrically by ``k // 2`` unless told otherwise, the detectors' BatchNorm
uses eps 1e-3 (momentum 0.03, flax's 0.97) and SiLU, the classifiers'
torchvision's eps 1e-5 and momentum 0.1 (flax's 0.9; ``CLASSIFIER_BN``).
In train mode BatchNorm normalises and updates its statistics as flax's
BatchNorm does (:func:`batch_norm_train`), and :class:`Dropout` draws its
mask from a generator the trainer hands it; in eval mode BatchNorm is
torch's own and dropout the identity.  Submodule names follow the Flax names
(``conv``, ``bn``, ``cv1``, ``m0``, ...) so that ``weights/jax_bridge.py``
maps a Flax variable tree onto a ``state_dict`` key by key.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from litepi_tpu_torch.ops.act import silu
from litepi_tpu_torch.parallel.mesh import all_reduce_sum, batch_group


# all four reference classifiers use torchvision's BatchNorm2d epsilon and
# momentum (flax momentum 0.9 in the JAX models)
CLASSIFIER_BN_EPS = 1e-5
CLASSIFIER_BN = {"bn_eps": CLASSIFIER_BN_EPS, "bn_momentum": 0.1}


def batch_norm_train(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """``bn`` in train mode as flax's ``nn.BatchNorm`` trains.

    Three things differ from torch's train mode: the statistics are taken
    in float32 (float64 for a float64 input) as E[x] and max(0, E[x^2] -
    E[x]^2) (flax's fast variance), the running variance takes that
    *biased* variance (torch's the unbiased one), and the output is ``(x -
    mean) * (rsqrt(var + eps) * weight) + bias`` in that precision, cast
    to the input's dtype.  The running statistics move as ``f * running +
    (1 - f) * batch`` with flax's momentum ``f = 1 - bn.momentum``.  Eval
    mode calls ``bn`` itself, so serving is torch's BatchNorm.

    Inside ``parallel/mesh.py::global_batch`` over several data ranks the
    moments are the global batch's, as under the JAX package's
    data-sharded ``jit``: one all-reduce of the per-rank sums of x and x^2
    and the element count (differentiable: its backward is one all-reduce
    too), so the running statistics move identically on every rank."""
    xf = at_least_float32(x)
    group = batch_group()
    if group is None:
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    else:
        c = xf.shape[1]
        sums = all_reduce_sum(torch.cat([
            xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
            xf.new_full((1,), xf.numel() // c),
        ]), group)
        mean = sums[:c] / sums[2 * c]
        var = torch.clamp(sums[c:2 * c] / sums[2 * c] - mean * mean, min=0.0)
    with torch.no_grad():
        f = 1.0 - bn.momentum
        bn.running_mean.copy_(f * bn.running_mean + (1.0 - f) * mean)
        bn.running_var.copy_(f * bn.running_var + (1.0 - f) * var)
        bn.num_batches_tracked.add_(1)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
    return y.to(x.dtype)


def batch_norm_flax(bn: nn.BatchNorm2d, x: torch.Tensor, training: bool) -> torch.Tensor:
    """``bn`` as flax's ``nn.BatchNorm(dtype=x.dtype)`` computes in either
    mode: in train mode :func:`batch_norm_train`; in eval mode the running
    statistics in ``(x - mean) * (rsqrt(var + eps) * weight) + bias``,
    computed in float32 (float64 for a float64 input) and cast to ``x``'s
    dtype.  torch's eval-mode BatchNorm folds ``weight * rsqrt(var + eps)``
    into a scale and shift first, which rounds otherwise in bf16."""
    if training:
        return batch_norm_train(bn, x)
    xf = at_least_float32(x)
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    y = (xf - bn.running_mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
    return y.to(x.dtype)


class Dropout(nn.Module):
    """flax's ``nn.Dropout``: in train mode each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, in the
    input's dtype; the identity in eval mode.  The mask is drawn from
    :attr:`generator` (a ``torch.Generator`` on the input's device, which
    the train step sets), or from torch's default generator when it is
    None."""

    def __init__(self, rate: float) -> None:
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def at_least_float32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as it is when its dtype is wider (float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


_ACTS = {
    None: _identity,
    "relu": F.relu,
    "relu6": F.relu6,
    "silu": silu,  # in bf16 rounded at each step, as the JAX program
}


def conv_bias_apart(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)``, but in bf16 with the bias added as an op of its own
    after the conv's output is rounded, as a biased bf16 flax ``nn.Conv``
    rounds (its conv output, then the bias add).  The JAX ResNet18's deploy
    form rounds so; a single rounding put the port's bf16 probabilities at
    1.76x JAX's own bf16 drift, two at 0.35x
    (tests/torch_bf16_layers.py, tests/test_torch_bf16_zoo_parity.py)."""
    if conv.bias is None or x.dtype != torch.bfloat16:
        return conv(x)
    y = F.conv2d(x, conv.weight, None, conv.stride, conv.padding, conv.dilation, conv.groups)
    return y + conv.bias[:, None, None]


class ConvBN(nn.Module):
    """Conv2d + BatchNorm (eps ``bn_eps``) + ``act`` (``"silu"``,
    ``"relu"``, ``"relu6"`` or None).  ``fused=True`` is the deploy form: a
    biased conv with BN folded in (``weights/fold_bn.py``); with
    ``bias_apart`` its bf16 bias add rounds apart (:func:`conv_bias_apart`),
    which ResNet18 and EfficientNet-B0 set: against JAX's bf16 drift it
    takes ResNet18's probabilities from 1.76x to 0.35x and, with SiLU
    rounded at each step, EfficientNet-B0's cls scores from 1.94x to 0.79x;
    it leaves the default pair's outputs as they are and takes
    MobileNetV2's cls scores from 1.12x to 2.16x (``python -m
    tests.torch_bf16_layers --pairs``; ROADMAP section 3).
    ``act="silu"`` rounds at each step in bf16 (``ops/act.py``).
    ``bn_momentum`` is torch's (0.03 for the detectors, 0.1 for the
    classifiers: ``CLASSIFIER_BN``); BatchNorm trains as flax's
    (:func:`batch_norm_train`).
    ``padding`` -1 pads by ``kernel // 2``; 0 or more pads by that much
    (YOLOv5's 6x6/2 stem pads by 2)."""

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
        bias_apart: bool = False,
        bn_momentum: float = 0.03,
    ) -> None:
        super().__init__()
        self.bias_apart = bias_apart
        pad = kernel // 2 if padding < 0 else padding
        self.conv = nn.Conv2d(
            c_in, c_out, kernel, stride, pad, groups=groups, bias=fused
        )
        self.bn = None if fused else nn.BatchNorm2d(c_out, eps=bn_eps, momentum=bn_momentum)
        self.act = _ACTS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_bias_apart(self.conv, x) if self.bias_apart else self.conv(x)
        if self.bn is not None:
            x = batch_norm_train(self.bn, x) if self.training else self.bn(x)
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
