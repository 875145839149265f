"""YOLOv9-E (Ultralytics ``ultralytics/cfg/models/v9/yolov9e.yaml``; Wang,
Yeh and Liao, "YOLOv9: Learning What You Want to Learn Using Programmable
Gradient Information", arXiv:2402.13616), on (B, C, H, W) tensors.

GELAN (generalised ELAN) blocks (:class:`RepNCSPELAN4`: two
:class:`RepCSP` of :class:`RepBottleneck`, each opening with a
:class:`RepConv`) and :class:`ADown` downsamplers make two backbones.  PGI's
first backbone (layers 1-9) is projected at each of its five levels by a
:class:`CBLinear` (one biased 1x1 conv, split along channels), and
:func:`cbfuse` adds those projections into every level of the second
backbone (layers 15-29), each resized to the level's size by nearest
neighbour; then :class:`SPPELAN`, a PAN head of GELAN blocks and v8's
``Detect`` (``models/yolo.py::DetectHead``).  The output contract is the
other injected detectors': ``reg`` (B, A, 4*reg_max), ``cls`` (B, A, nc)
in float32, anchors row-major per level, P3..P5.

A :class:`RepConv` trains as two ConvBN branches (3x3 and 1x1, summed, then
SiLU) and deploys as one biased 3x3 conv: ``YoloV9E(nc)`` is the trained
form, whose raw state dict the plain reference (``cardbench/reference/
yolov9.py``) loads too; :meth:`YoloV9E.deploy_form` gives the deployed
model and its state, every RepConv folded in float32
(``weights/fold_bn.py::fold_repconvs``).  The pipeline runs an injected
detector in the form it returns: the folded convs then take the act
kernel's bias mode (``ConvBN.folds_bias``), every other BatchNorm stays
unfolded in its BatchNorm mode.  The twelve GELAN blocks run under the
``litepi.elan`` span, the five fuses under ``litepi.cbfuse`` and the eight
ADowns' pools under ``litepi.adown``.  Every
width is a multiple of 8, so the model runs channels last whole.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from litepi_tpu_torch.core.metrics import span
from litepi_tpu_torch.core.types import DetectorConfig
from litepi_tpu_torch.kernels import LAUNCHES
from litepi_tpu_torch.kernels.adown import (
    adown_front_cuda,
    adown_front_plain,
    takes_adown_kernel,
)
from litepi_tpu_torch.models.layers import ConvBN, upsample2x_nearest
from litepi_tpu_torch.models.yolo import DetectHead
from litepi_tpu_torch.ops.act import silu
from litepi_tpu_torch.weights.fold_bn import fold_repconvs

StateDict = Dict[str, torch.Tensor]


class RepConv(nn.Module):
    """``silu(conv1(x) + conv2(x))``: a 3x3 and a 1x1 ConvBN, neither with
    an activation (as trained; no identity branch)."""

    def __init__(self, c_in: int, c_out: int) -> None:
        super().__init__()
        self.conv1 = ConvBN(c_in, c_out, 3, act=None)
        self.conv2 = ConvBN(c_in, c_out, 1, act=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return silu(self.conv1(x) + self.conv2(x))


class RepBottleneck(nn.Module):
    """``x + cv2(cv1(x))``: ``cv1`` a :class:`RepConv`, or with ``deploy``
    its folded 3x3 conv with SiLU; ``cv2`` a 3x3 ConvBN."""

    def __init__(self, c: int, deploy: bool = False) -> None:
        super().__init__()
        self.cv1 = ConvBN(c, c, 3, fused=True) if deploy else RepConv(c, c)
        self.cv2 = ConvBN(c, c, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.cv2(self.cv1(x))


class RepCSP(nn.Module):
    """C3 of ``n`` RepBottlenecks: ``cv3(cat(m(cv1 x), cv2 x))``."""

    def __init__(self, c_in: int, c_out: int, n: int = 2, deploy: bool = False) -> None:
        super().__init__()
        hidden = c_out // 2
        self.cv1 = ConvBN(c_in, hidden, 1)
        self.cv2 = ConvBN(c_in, hidden, 1)
        self.cv3 = ConvBN(2 * hidden, c_out, 1)
        self.m = nn.Sequential(*(RepBottleneck(hidden, deploy) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat((self.m(self.cv1(x)), self.cv2(x)), dim=1))


class RepNCSPELAN4(nn.Module):
    """GELAN's block: ``cv1`` (1x1 to c3) in two halves; ``cv2`` (RepCSP
    then a 3x3 ConvBN) on the second half, ``cv3`` (the same) on that;
    ``cv4`` (1x1) on the four parts.  Runs under the ``litepi.elan`` span."""

    def __init__(self, c_in: int, c_out: int, c3: int, c4: int, n: int = 2,
                 deploy: bool = False) -> None:
        super().__init__()
        self.cv1 = ConvBN(c_in, c3, 1)
        self.cv2 = nn.Sequential(RepCSP(c3 // 2, c4, n, deploy), ConvBN(c4, c4, 3))
        self.cv3 = nn.Sequential(RepCSP(c4, c4, n, deploy), ConvBN(c4, c4, 3))
        self.cv4 = ConvBN(c3 + 2 * c4, c_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("elan"):
            ys = list(self.cv1(x).chunk(2, dim=1))
            ys.append(self.cv2(ys[-1]))
            ys.append(self.cv3(ys[-1]))
            return self.cv4(torch.cat(ys, dim=1))


class ADown(nn.Module):
    """A 2x2 stride-1 average pool, then one half through a 3x3/2 ConvBN and
    the other through a 3x3/2 max pool and a 1x1 ConvBN, concatenated.  The
    pools (the front end, under the ``litepi.adown`` span) are one pass of
    ``csrc/adown.cu`` on a bf16 card input with no gradient to record, and
    ATen's chain elsewhere (``kernels/adown.py``)."""

    def __init__(self, c_in: int, c_out: int) -> None:
        super().__init__()
        self.cv1 = ConvBN(c_in // 2, c_out // 2, 3, 2, padding=1)
        self.cv2 = ConvBN(c_in // 2, c_out // 2, 1, 1, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("adown"):
            front = adown_front_cuda if takes_adown_kernel(x) else adown_front_plain
            x1, x2 = front(x)
        return torch.cat((self.cv1(x1), self.cv2(x2)), dim=1)


class SPPELAN(nn.Module):
    """1x1 to c3, three chained 5x5 stride-1 max pools, 1x1 on the four."""

    def __init__(self, c_in: int, c_out: int, c3: int, pool: int = 5) -> None:
        super().__init__()
        self.pool = pool
        self.cv1 = ConvBN(c_in, c3, 1)
        self.cv5 = ConvBN(4 * c3, c_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], self.pool, 1, self.pool // 2))
        return self.cv5(torch.cat(ys, dim=1))


class CBLinear(nn.Module):
    """One biased 1x1 conv to ``sum(splits)`` channels, split along them
    (views)."""

    def __init__(self, c_in: int, splits: Sequence[int]) -> None:
        super().__init__()
        self.splits = list(splits)
        self.conv = nn.Conv2d(c_in, sum(splits), 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.conv(x).split(self.splits, dim=1)


def cbfuse(sources: Sequence[torch.Tensor], target: torch.Tensor) -> torch.Tensor:
    """``CBFuse``: each of ``sources`` resized to ``target``'s size by
    nearest neighbour, summed in order, then ``target`` added, into one new
    map in ``target``'s layout.  Each source is added through a broadcast
    view of the output, (B, C, h, f, w, f) against (B, C, h, 1, w, 1): no
    resized copy and no stack of the maps is made.  Every source's size
    divides the target's where the input is a multiple of 32; a source's
    that does not raises.  Counts the call in ``LAUNCHES["cbfuse"]``."""
    LAUNCHES["cbfuse"] += 1
    b, c, h, w = target.shape
    out = torch.empty_like(target)
    for i, x in enumerate((*sources, target)):
        sh, sw = x.shape[2:]
        if h % sh or w % sw:
            raise ValueError(f"a {sh}x{sw} source does not divide the {h}x{w} target")
        view = out.view(b, c, sh, h // sh, sw, w // sw)
        part = x[:, :, :, None, :, None]
        if i == 0:
            view.copy_(part)
        else:
            view.add_(part)
    return out


class YoloV9E(nn.Module):
    """YOLOv9-E.  Input (B, 3, S, S) in the weights' dtype, scaled to [0, 1],
    RGB; S a multiple of 32.  ``deploy`` builds the form whose RepConvs are
    folded (:meth:`deploy_form`)."""

    def __init__(self, num_classes: int = 1, reg_max: int = 16, deploy: bool = False) -> None:
        super().__init__()
        self.num_classes, self.reg_max = num_classes, reg_max

        def elan(*args):
            return RepNCSPELAN4(*args, deploy=deploy)

        self.conv1 = ConvBN(3, 64, 3, 2)                           # 1  P1/2
        self.conv2 = ConvBN(64, 128, 3, 2)                         # 2  P2/4
        self.elan3 = elan(128, 256, 128, 64)                       # 3
        self.down4 = ADown(256, 256)                               # 4  P3/8
        self.elan5 = elan(256, 512, 256, 128)                      # 5
        self.down6 = ADown(512, 512)                               # 6  P4/16
        self.elan7 = elan(512, 1024, 512, 256)                     # 7
        self.down8 = ADown(1024, 1024)                             # 8  P5/32
        self.elan9 = elan(1024, 1024, 512, 256)                    # 9
        self.cbl10 = CBLinear(64, [64])                            # 10
        self.cbl11 = CBLinear(256, [64, 128])                      # 11
        self.cbl12 = CBLinear(512, [64, 128, 256])                 # 12
        self.cbl13 = CBLinear(1024, [64, 128, 256, 512])           # 13
        self.cbl14 = CBLinear(1024, [64, 128, 256, 512, 1024])     # 14
        self.conv15 = ConvBN(3, 64, 3, 2)                          # 15 P1/2, 16 CBFuse
        self.conv17 = ConvBN(64, 128, 3, 2)                        # 17 P2/4, 18 CBFuse
        self.elan19 = elan(128, 256, 128, 64)                      # 19
        self.down20 = ADown(256, 256)                              # 20 P3/8, 21 CBFuse
        self.elan22 = elan(256, 512, 256, 128)                     # 22
        self.down23 = ADown(512, 512)                              # 23 P4/16, 24 CBFuse
        self.elan25 = elan(512, 1024, 512, 256)                    # 25
        self.down26 = ADown(1024, 1024)                            # 26 P5/32, 27 CBFuse
        self.elan28 = elan(1024, 1024, 512, 256)                   # 28
        self.spp29 = SPPELAN(1024, 512, 256)                       # 29
        self.elan32 = elan(1536, 512, 512, 256)                    # 30-32
        self.elan35 = elan(1024, 256, 256, 128)                    # 33-35 P3 out
        self.down36 = ADown(256, 256)                              # 36
        self.elan38 = elan(768, 512, 512, 256)                     # 37-38 P4 out
        self.down39 = ADown(512, 512)                              # 39
        self.elan41 = elan(1024, 512, 1024, 512)                   # 40-41 P5 out
        self.head = DetectHead(DetectorConfig(                     # 42 Detect
            num_classes=num_classes, base_channels=(64, 128, 256, 512, 512), width=1.0,
            reg_max=reg_max))

    def deploy_form(self, state: StateDict) -> Tuple[nn.Module, StateDict]:
        """(the deployed model, ``state`` in its form): ``state``, a raw
        state dict of this model (BatchNorm unfolded), with each RepConv's
        two branches folded into one biased 3x3 conv, and a model built
        with ``deploy`` to load it.  Any state this model loads gives the
        same outputs in the deployed model, up to the fold's rounding."""
        names = [name for name, m in self.named_modules() if isinstance(m, RepConv)]
        return (YoloV9E(self.num_classes, self.reg_max, deploy=True),
                fold_repconvs(state, names))

    def _fuse(self, cb, level: int, target: torch.Tensor) -> torch.Tensor:
        with span("cbfuse"):
            return cbfuse([c[level] for c in cb[level:]], target)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.contiguous(memory_format=torch.channels_last)
        y = self.conv1(x)
        cb = [self.cbl10(y)]
        y = self.elan3(self.conv2(y))
        cb.append(self.cbl11(y))
        y = self.elan5(self.down4(y))
        cb.append(self.cbl12(y))
        y = self.elan7(self.down6(y))
        cb.append(self.cbl13(y))
        cb.append(self.cbl14(self.elan9(self.down8(y))))
        del y
        y = self._fuse(cb, 0, self.conv15(x))
        y = self._fuse(cb, 1, self.conv17(y))
        b3 = self.elan22(self._fuse(cb, 2, self.down20(self.elan19(y))))
        b4 = self.elan25(self._fuse(cb, 3, self.down23(b3)))
        b5 = self.spp29(self.elan28(self._fuse(cb, 4, self.down26(b4))))
        del cb, y
        h4 = self.elan32(torch.cat([upsample2x_nearest(b5), b4], dim=1))
        n3 = self.elan35(torch.cat([upsample2x_nearest(h4), b3], dim=1))
        n4 = self.elan38(torch.cat([self.down36(n3), h4], dim=1))
        n5 = self.elan41(torch.cat([self.down39(n4), b5], dim=1))
        out = self.head((n3, n4, n5))
        return {"reg": out["reg"].float(), "cls": out["cls"].float()}
