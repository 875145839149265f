"""Reference Ultralytics YOLO-World-v2 detector at scale l
(``ultralytics/cfg/models/v8/yolov8-worldv2.yaml``: depth 1.0, width 1.0,
max_channels 512; arXiv:2401.17270), plain float32, BatchNorm unfolded (eps
1e-3), a fixed vocabulary of ``num_classes`` prompts folded in.

The layer table of the yaml as ``parse_model`` builds it at scale l, each
block written out as the published code computes it:

* the backbone, YOLOv8-L's: Conv 3->64/2, Conv 64->128/2, C2f(128, n 3,
  shortcut), Conv ->256/2, C2f(256, n 6), Conv ->512/2, C2f(512, n 6), Conv
  ->512/2, C2f(512, n 3), SPPF(512);
* the neck, four ``C2fAttn(c1, c2, n=3, ec=c2/2, nh=c2/64)`` (no shortcut)
  at P4 (1024->512), P3 (768->256), P4 (768->512) and P5 (1024->512):
  ``cv2(cat[a, b, m0(b), m1(.), m2(.), attn(m2 out)])``;
* ``MaxSigmoidAttnBlock(c, c, nh, ec=c)`` (no ``ec`` conv: ec = c):
  ``embed.view(b, nh, 32, h, w)``, the einsum with the guide
  ``"bmchw,nmc->bmhwn"``, the max over the classes n, ``/ sqrt(32) +
  bias``, the sigmoid, and ``proj_conv(x)`` (3x3, no act) viewed as (b, nh,
  32, h, w) times those weights;
* ``WorldDetect(nc, 512, with_bn=True)``: per level v8's DFL box branch
  (two 3x3 convs to 64, a 1x1 conv to 64) and the class branch (two 3x3
  convs to 256, a 1x1 conv to 512), then ``BNContrastiveHead``.

Departures from the published code: the module names are the program's
(``stem``, ``c2fattn_p4a.attn.guide``, ``cls0_embed``, ``cls0_out``, ...);
the vocabulary is folded in as YOLO-World deploys a fixed one (its
re-parameterisation for deployment): each block's guide ``gl(text)`` is
the weight of a bias-free grouped 1x1 conv (``attn.guide``, (nh * nc, 32,
1, 1), head m's classes in rows m * nc ..; YOLO-World's per-head
``guide_convs`` as one conv, read here as the einsum's guide and never run
as a conv), and each level's ``BNContrastiveHead`` is its BatchNorm
(``cls{i}_norm``) then a biased 1x1 conv (``cls{i}_out``: the normalised
text embeddings times ``exp(logit_scale)``, and the bias); the einsum is
computed :data:`CHUNK` classes at a time, so that the scores of a
32-frame batch at 1280 fit on one card (the same products, in pieces,
each chunk's max folded into a running max); the DFL conv is not a
module (the decode is ``reference/two_stage.py``'s).
"""

from __future__ import annotations

import torch
from torch import nn

from cardbench.reference.layers import C2f, SPPF, Bottleneck, ConvBN, flatten_anchors, upsample2x

SCALE_L = {"width": 1.0, "depth": 1.0, "max_channels": 512}
HEAD_DIM = 32
EMBED = 512
CHUNK = 64  # classes scored at once by the einsum


class MaxSigmoidAttn(nn.Module):
    def __init__(self, c, nh, nc):
        super().__init__()
        self.nh, self.hc, self.nc = nh, c // nh, nc
        self.guide = nn.Conv2d(c, nh * nc, 1, groups=nh, bias=False)
        self.bias = nn.Parameter(torch.zeros(nh))
        self.proj = ConvBN(c, c, 3, act=None)

    def forward(self, x):
        bs, _, h, w = x.shape
        guide = self.guide.weight.view(self.nh, self.nc, self.hc).transpose(0, 1)  # (n, m, c)
        embed = x.view(bs, self.nh, self.hc, h, w)
        aw = None
        for n0 in range(0, self.nc, CHUNK):
            part = torch.einsum("bmchw,nmc->bmhwn", embed, guide[n0:n0 + CHUNK]).max(dim=-1)[0]
            aw = part if aw is None else torch.maximum(aw, part)
        aw = aw / (self.hc ** 0.5)
        aw = aw + self.bias[None, :, None, None]
        aw = aw.sigmoid()
        x = self.proj(x)
        x = x.view(bs, self.nh, -1, h, w)
        x = x * aw.unsqueeze(2)
        return x.view(bs, -1, h, w)


class C2fAttn(nn.Module):
    def __init__(self, c1, c2, nc, n=3, e=0.5):
        super().__init__()
        self.c, self.n = int(c2 * e), n
        self.cv1 = ConvBN(c1, 2 * self.c, 1)
        self.cv2 = ConvBN((3 + n) * self.c, c2, 1)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(self.c, False))
        self.attn = MaxSigmoidAttn(self.c, self.c // HEAD_DIM, nc)

    def forward(self, x):
        y = list(self.cv1(x).chunk(2, 1))
        for i in range(self.n):
            y.append(getattr(self, f"m{i}")(y[-1]))
        y.append(self.attn(y[-1]))
        return self.cv2(torch.cat(y, 1))


class YoloWorldV2L(nn.Module):
    """Input (B, 3, S, S) RGB in [0, 1]."""

    def __init__(self, nc, reg_max):
        super().__init__()
        self.stem = ConvBN(3, 64, 3, 2)                            # 0  P1/2
        self.down1 = ConvBN(64, 128, 3, 2)                         # 1  P2/4
        self.c2f1 = C2f(128, 128, 3, True)                         # 2
        self.down2 = ConvBN(128, 256, 3, 2)                        # 3  P3/8
        self.c2f2 = C2f(256, 256, 6, True)                         # 4
        self.down3 = ConvBN(256, 512, 3, 2)                        # 5  P4/16
        self.c2f3 = C2f(512, 512, 6, True)                         # 6
        self.down4 = ConvBN(512, 512, 3, 2)                        # 7  P5/32
        self.c2f4 = C2f(512, 512, 3, True)                         # 8
        self.sppf = SPPF(512, 512, 5)                              # 9
        self.c2fattn_p4a = C2fAttn(1024, 512, nc)                  # 10-12
        self.c2fattn_p3 = C2fAttn(768, 256, nc)                    # 13-15
        self.bu_down3 = ConvBN(256, 256, 3, 2)                     # 16
        self.c2fattn_p4b = C2fAttn(768, 512, nc)                   # 17-18
        self.bu_down4 = ConvBN(512, 512, 3, 2)                     # 19
        self.c2fattn_p5 = C2fAttn(1024, 512, nc)                   # 20-21
        c_reg = max(16, 256 // 4, 4 * reg_max)                     # 22 WorldDetect
        c_cls = max(256, min(nc, 100))
        for i, f in enumerate((256, 512, 512)):
            setattr(self, f"reg{i}_cv1", ConvBN(f, c_reg, 3))
            setattr(self, f"reg{i}_cv2", ConvBN(c_reg, c_reg, 3))
            setattr(self, f"reg{i}_out", nn.Conv2d(c_reg, 4 * reg_max, 1))
            setattr(self, f"cls{i}_cv1", ConvBN(f, c_cls, 3))
            setattr(self, f"cls{i}_cv2", ConvBN(c_cls, c_cls, 3))
            setattr(self, f"cls{i}_embed", nn.Conv2d(c_cls, EMBED, 1))
            setattr(self, f"cls{i}_norm", nn.BatchNorm2d(EMBED, eps=1e-3))
            setattr(self, f"cls{i}_out", nn.Conv2d(EMBED, nc, 1))

    def forward(self, x):
        p3 = self.c2f2(self.down2(self.c2f1(self.down1(self.stem(x)))))
        p4 = self.c2f3(self.down3(p3))
        p5 = self.sppf(self.c2f4(self.down4(p4)))
        t4 = self.c2fattn_p4a(torch.cat([upsample2x(p5), p4], 1))
        n3 = self.c2fattn_p3(torch.cat([upsample2x(t4), p3], 1))
        n4 = self.c2fattn_p4b(torch.cat([self.bu_down3(n3), t4], 1))
        n5 = self.c2fattn_p5(torch.cat([self.bu_down4(n4), p5], 1))
        reg, cls = [], []
        for i, f in enumerate((n3, n4, n5)):
            r = getattr(self, f"reg{i}_cv2")(getattr(self, f"reg{i}_cv1")(f))
            reg.append(flatten_anchors(getattr(self, f"reg{i}_out")(r)))
            k = getattr(self, f"cls{i}_cv2")(getattr(self, f"cls{i}_cv1")(f))
            k = getattr(self, f"cls{i}_norm")(getattr(self, f"cls{i}_embed")(k))
            cls.append(flatten_anchors(getattr(self, f"cls{i}_out")(k)))
        return {"reg": torch.cat(reg, dim=1), "cls": torch.cat(cls, dim=1)}


def build(spec: dict) -> nn.Module:
    scale = {k: spec.get(k) for k in SCALE_L}
    if scale != SCALE_L:
        raise ValueError(f"the YOLO-World reference is scale l {SCALE_L}, not {scale}")
    return YoloWorldV2L(spec["num_classes"], spec["reg_max"])
