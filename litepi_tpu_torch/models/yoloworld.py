"""YOLO-World-v2 at scale l (Ultralytics ``ultralytics/cfg/models/v8/
yolov8-worldv2.yaml``: depth 1.0, width 1.0, max_channels 512; Cheng et
al., "YOLO-World: Real-Time Open-Vocabulary Object Detection",
arXiv:2401.17270), with a fixed vocabulary folded into its weights, on
(B, C, H, W) tensors.

The backbone is YOLOv8-L's (C2f stages, SPPF).  The neck is the v2
single-path vision-language PAN: four :class:`C2fAttn` blocks, each a C2f
of three plain bottlenecks whose last output also passes through a
max-sigmoid text attention (:class:`MaxSigmoidAttn`): every head of 32
channels scores each pixel against each class's guide vector, and the
sigmoid of the best score gates that head's channels of a 3x3 projection.
The head is ``WorldDetect(nc, 512, with_bn=True)``: v8's DFL box branch,
and a class branch of two 3x3 convs and a 1x1 embedding conv to 512, then
``BNContrastiveHead``: BatchNorm, then the dot with each class's text
embedding, scaled and biased (on the card in bf16, one hand-written GEMM
per level, ``csrc/vocab.cu``, that writes the float32 logits itself).

The vocabulary is folded in as YOLO-World deploys a fixed ("offline")
vocabulary: each block's text guides are one bias-free grouped 1x1 conv
(``attn.guide``, weight (heads * nc, 32, 1, 1): YOLO-World's per-head
``guide_convs`` as one conv), and each level's contrastive dot, scale and
bias are a biased 1x1 conv (``cls{i}_out``, 512 -> nc).  The output
contract is YoloLitePi's: ``reg`` (B, A, 4*reg_max), ``cls`` (B, A, nc)
in float32, anchors row-major per level, P3..P5.  BatchNorm stays in the
module (eps 1e-3); the pipeline runs it unfolded, as it runs every
injected detector.

The model runs channels last from its input on, as YOLO12-L does; no
block needs NCHW (every width is a multiple of 8).  Submodule names are
the plain reference's (``cardbench/reference/yoloworld.py``): one raw
state dict loads into both.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
from torch import nn

from litepi_tpu_torch.core.metrics import span
from litepi_tpu_torch.kernels import LAUNCHES
from litepi_tpu_torch.kernels.vocab import (
    takes_vocab_kernel,
    vocab_logits_cuda,
    vocab_logits_plain,
)
from litepi_tpu_torch.models.layers import (
    C2f,
    SPPF,
    Bottleneck,
    ConvBN,
    flatten_anchors,
    upsample2x_nearest,
)

HEAD_DIM = 32  # every C2fAttn's attention heads are 32 channels wide
EMBED = 512  # the text embedding width of WorldDetect's contrastive head
# the largest temporary of the chunked max-sigmoid core: one chunk's
# bf16 scores, before their max
MAXSIG_TEMP_BYTES = 2 << 30


def max_sigmoid_plain(x: torch.Tensor, guide: torch.Tensor, bias: torch.Tensor,
                      heads: int) -> torch.Tensor:
    """The max-sigmoid core with every score computed at once, in float32:
    ``x`` (B, heads * 32, H, W), ``guide`` (heads * nc, 32, 1, 1), ``bias``
    (heads,).  Returns ``sigmoid(max_n s[b, m, n] / sqrt(32) + bias[m])``,
    (B, heads, H, W) float32, where ``s[b, m, n, h, w] = sum_d guide[m * nc
    + n, d] * x[b, m * 32 + d, h, w]``."""
    b, c, h, w = x.shape
    g = guide.float().reshape(heads, -1, HEAD_DIM)
    xs = x.float().reshape(b, heads, HEAD_DIM, h, w)
    scores = torch.einsum("bmdhw,mnd->bmnhw", xs, g)
    best = scores.amax(dim=2)
    return torch.sigmoid(best / math.sqrt(HEAD_DIM) + bias.float()[None, :, None, None])


def max_sigmoid_chunked(x: torch.Tensor, guide: torch.Tensor, bias: torch.Tensor, heads: int,
                        chunk: int) -> torch.Tensor:
    """The same core as :func:`max_sigmoid_plain`, ``chunk`` classes at a
    time: per chunk one batched product in ``x``'s dtype (heads as the
    batch), reduced by its max over the chunk and folded into a running
    max; then the scale, the bias and the sigmoid in float32.  Each chunk's
    scores, (heads, chunk, B * H * W) in ``x``'s dtype, are the largest
    temporary.  The pixels are the product's last axis, so that its output
    rows are aligned whatever the chunk (a 1,203-class vocabulary splits
    into odd chunks) and the max reads them along the rows; ``x``'s side is
    a view where it is channels last (pixel stride C, head stride 32)."""
    b, c, h, w = x.shape
    xs = x.permute(0, 2, 3, 1).reshape(b * h * w, heads, HEAD_DIM).permute(1, 2, 0)
    g = guide.to(x.dtype).reshape(heads, -1, HEAD_DIM)
    best = None
    for n0 in range(0, g.shape[1], chunk):
        part = torch.matmul(g[:, n0:n0 + chunk], xs).amax(dim=1)
        best = part if best is None else torch.maximum(best, part)
    best = best.float().reshape(heads, b, h, w).transpose(0, 1)
    return torch.sigmoid(best / math.sqrt(HEAD_DIM) + bias.float()[None, :, None, None])


def maxsig_chunk(x: torch.Tensor, heads: int, nc: int, limit: int = MAXSIG_TEMP_BYTES) -> int:
    """Classes per chunk of :func:`max_sigmoid_chunked` for ``x`` and
    ``nc`` classes: the fewest chunks whose scores each fit in ``limit``
    bytes (one class a chunk at least), the classes spread evenly over
    them."""
    b, _, h, w = x.shape
    most = max(1, limit // (heads * b * h * w * x.element_size()))
    pieces = -(-nc // most)
    return -(-nc // pieces)


def max_sigmoid_attention(x: torch.Tensor, guide: torch.Tensor, bias: torch.Tensor,
                          heads: int) -> torch.Tensor:
    """The max-sigmoid text attention weights (B, heads, H, W), float32.
    On the card, in any dtype, :func:`max_sigmoid_chunked` in chunks of
    :func:`maxsig_chunk`, so that no temporary passes
    :data:`MAXSIG_TEMP_BYTES`; on the CPU :func:`max_sigmoid_plain`.
    Counts the call in ``LAUNCHES["maxsig"]``."""
    LAUNCHES["maxsig"] += 1
    if not x.is_cuda:
        return max_sigmoid_plain(x, guide, bias, heads)
    chunk = maxsig_chunk(x, heads, guide.shape[0] // heads)
    return max_sigmoid_chunked(x, guide, bias, heads, chunk)


class MaxSigmoidAttn(nn.Module):
    """``MaxSigmoidAttnBlock(c, c, nh=heads, ec=c)`` with its text guides
    folded in: ``guide`` the grouped 1x1 conv of the guides (never run as a
    conv: its weight feeds the core), ``bias`` (heads,), ``proj`` a 3x3
    ConvBN without activation whose head m's channels the core's weights
    ``aw[:, m]`` scale.  The core runs under the ``litepi.maxsig`` span."""

    def __init__(self, c: int, num_classes: int) -> None:
        super().__init__()
        self.heads = c // HEAD_DIM
        self.guide = nn.Conv2d(c, self.heads * num_classes, 1, groups=self.heads, bias=False)
        self.bias = nn.Parameter(torch.zeros(self.heads))
        self.proj = ConvBN(c, c, 3, act=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        with span("maxsig"):
            aw = max_sigmoid_attention(x, self.guide.weight, self.bias, self.heads)
        y = self.proj(x)
        # a view per head of y's channels, channels last or not
        out = y.view(b, self.heads, HEAD_DIM, h, w) * aw.to(y.dtype)[:, :, None]
        return out.view(b, c, h, w)


class C2fAttn(nn.Module):
    """C2f with text attention (``C2fAttn(c_in, c_out, n, ec=c_out // 2,
    nh=c_out // 64)``, no shortcut): ``cv1`` to two halves, ``n``
    bottlenecks on the second keeping each output, the attention on the
    last one, ``cv2`` on all ``3 + n`` of them; the whole block under the
    ``litepi.c2fattn`` span."""

    def __init__(self, c_in: int, c_out: int, num_classes: int, n: int = 3) -> None:
        super().__init__()
        hidden = c_out // 2
        self.n = n
        self.cv1 = ConvBN(c_in, 2 * hidden, 1)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(hidden, shortcut=False))
        self.attn = MaxSigmoidAttn(hidden, num_classes)
        self.cv2 = ConvBN((3 + n) * hidden, c_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("c2fattn"):
            ys = list(self.cv1(x).chunk(2, dim=1))
            for i in range(self.n):
                ys.append(getattr(self, f"m{i}")(ys[-1]))
            ys.append(self.attn(ys[-1]))
            return self.cv2(torch.cat(ys, dim=1))


def add_world_head(model: nn.Module, channels: Sequence[int], num_classes: int,
                   reg_max: int) -> None:
    """``WorldDetect(nc, 512, with_bn=True)`` in its offline-vocabulary
    form as submodules of ``model``, one set per level of ``channels``: v8's
    DFL box branch ``reg{i}_cv1``, ``reg{i}_cv2``, ``reg{i}_out``, and the
    class branch ``cls{i}_cv1``, ``cls{i}_cv2`` (3x3 ConvBN), ``cls{i}_embed``
    (1x1 to 512, biased), ``cls{i}_norm`` (BatchNorm) and ``cls{i}_out``
    (the contrastive dot as a biased 1x1 conv to ``num_classes``)."""
    c_reg = max(16, channels[0] // 4, 4 * reg_max)
    c_cls = max(channels[0], min(num_classes, 100))
    for i, f in enumerate(channels):
        setattr(model, f"reg{i}_cv1", ConvBN(f, c_reg, 3))
        setattr(model, f"reg{i}_cv2", ConvBN(c_reg, c_reg, 3))
        setattr(model, f"reg{i}_out", nn.Conv2d(c_reg, 4 * reg_max, 1))
        setattr(model, f"cls{i}_cv1", ConvBN(f, c_cls, 3))
        setattr(model, f"cls{i}_cv2", ConvBN(c_cls, c_cls, 3))
        setattr(model, f"cls{i}_embed", nn.Conv2d(c_cls, EMBED, 1))
        setattr(model, f"cls{i}_norm", nn.BatchNorm2d(EMBED, eps=1e-3, momentum=0.03))
        setattr(model, f"cls{i}_out", nn.Conv2d(EMBED, num_classes, 1))


def world_head(model: nn.Module, feats: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The head :func:`add_world_head` put on ``model``, on its P3..P5
    features: ``reg`` (B, A, 4*reg_max) and ``cls`` (B, A, nc) in float32,
    as ``yolov11.py::detect_head`` gives them.  The vocabulary-wide part,
    each level's BatchNorm and class logits written into one (B, A, nc)
    tensor, runs under the ``litepi.vocab`` span.  A level's logits are one
    launch of the class-head GEMM (``kernels/vocab.py``) where its BatchNorm
    output is a bf16 CUDA tensor with no gradient to record (one the kernel
    cannot take, such as an NCHW one, raises); elsewhere
    :func:`vocab_logits_plain`, the class conv, then the flatten and float32
    copy into ``cls``."""
    sizes = [f.shape[2] * f.shape[3] for f in feats]
    cls = feats[0].new_empty((feats[0].shape[0], sum(sizes), model.cls0_out.out_channels),
                             dtype=torch.float32)
    reg_out = []
    for i, f in enumerate(feats):
        r = getattr(model, f"reg{i}_cv2")(getattr(model, f"reg{i}_cv1")(f))
        reg_out.append(flatten_anchors(getattr(model, f"reg{i}_out")(r)))
        k = getattr(model, f"cls{i}_embed")(getattr(model, f"cls{i}_cv2")(
            getattr(model, f"cls{i}_cv1")(f)))
        with span("vocab"):
            e = getattr(model, f"cls{i}_norm")(k)
            conv = getattr(model, f"cls{i}_out")
            logits = vocab_logits_cuda if takes_vocab_kernel(e, conv) else vocab_logits_plain
            logits(e, conv.weight, conv.bias, cls, sum(sizes[:i]))
    return {"reg": torch.cat(reg_out, dim=1).float(), "cls": cls}


class YoloWorldV2L(nn.Module):
    """YOLO-World-v2 at scale l with ``num_classes`` text prompts folded
    in.  Input (B, 3, S, S) in the weights' dtype, scaled to [0, 1], RGB;
    S a multiple of 32."""

    def __init__(self, num_classes: int = 1, reg_max: int = 16) -> None:
        super().__init__()
        self.stem = ConvBN(3, 64, 3, 2)                           # 0  P1/2
        self.down1 = ConvBN(64, 128, 3, 2)                        # 1  P2/4
        self.c2f1 = C2f(128, 128, 3, True)                        # 2
        self.down2 = ConvBN(128, 256, 3, 2)                       # 3  P3/8
        self.c2f2 = C2f(256, 256, 6, True)                        # 4
        self.down3 = ConvBN(256, 512, 3, 2)                       # 5  P4/16
        self.c2f3 = C2f(512, 512, 6, True)                        # 6
        self.down4 = ConvBN(512, 512, 3, 2)                       # 7  P5/32
        self.c2f4 = C2f(512, 512, 3, True)                        # 8
        self.sppf = SPPF(512, 512, 5)                             # 9
        self.c2fattn_p4a = C2fAttn(1024, 512, num_classes)        # 10-12
        self.c2fattn_p3 = C2fAttn(768, 256, num_classes)          # 13-15
        self.bu_down3 = ConvBN(256, 256, 3, 2)                    # 16
        self.c2fattn_p4b = C2fAttn(768, 512, num_classes)         # 17-18
        self.bu_down4 = ConvBN(512, 512, 3, 2)                    # 19
        self.c2fattn_p5 = C2fAttn(1024, 512, num_classes)         # 20-21
        add_world_head(self, (256, 512, 512), num_classes, reg_max)  # 22

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.contiguous(memory_format=torch.channels_last)
        p3 = self.c2f2(self.down2(self.c2f1(self.down1(self.stem(x)))))
        p4 = self.c2f3(self.down3(p3))
        p5 = self.sppf(self.c2f4(self.down4(p4)))
        t4 = self.c2fattn_p4a(torch.cat([upsample2x_nearest(p5), p4], dim=1))
        n3 = self.c2fattn_p3(torch.cat([upsample2x_nearest(t4), p3], dim=1))
        n4 = self.c2fattn_p4b(torch.cat([self.bu_down3(n3), t4], dim=1))
        n5 = self.c2fattn_p5(torch.cat([self.bu_down4(n4), p5], dim=1))
        return world_head(self, (n3, n4, n5))
