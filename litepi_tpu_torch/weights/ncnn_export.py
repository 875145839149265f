"""NCNN ``.param``/``.bin`` graph emission (numpy only).

The port's copy of the JAX package's ``weights/ncnn_export.py``.  It takes
the Flax-named numpy variable trees that the port's importers return and
its checkpoint holds (``weights/checkpoint.py``), folds their BatchNorm
(``weights/fold_bn.py::fold_detector_pipeline_vars``, bit-equal to the JAX
fold) and writes the graph the reference deploys (pnnx's layer sequence,
in-graph DFL decode and baked anchor/stride tables): yolo_plus v1/v2 and
yolov8n (:class:`_GraphEmitter`), yolov5nu (:class:`_V5uEmitter`),
yolov11n with C3k2 and C2PSA attention (:class:`_V11Emitter`) and the
ShuffleNetV2 classifier (:class:`_ShuffleNetV2Emitter`), fp32 or fp16
weights.  The files are byte-equal to the JAX emitter's on the same tree
(tests/test_torch_export_ncnn.py).

Checks: the emitted graph passes
:func:`~litepi_tpu_torch.weights.ncnn_import.verify_ncnn_topology` (asserted
at export time); it runs through the port's torch interpreter
:func:`~litepi_tpu_torch.weights.ncnn_import.run_ncnn_graph` to the port's
model plus decode.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from litepi_tpu_torch.core.types import DetectorConfig
from litepi_tpu_torch.weights.ncnn_import import (
    _TAG_FP16,
    NcnnLayer,
    verify_ncnn_topology,
)

_SLICE_AUTO = -233  # ncnn's "split the remainder evenly" sentinel


# --------------------------------------------------------------------------- #
# graph construction
# --------------------------------------------------------------------------- #


class _Builder:
    """Accumulates layers with pnnx-style naming and numeric blob ids.

    Blobs are logical during construction — a blob consumed by several
    layers is legal here and resolved by :meth:`finalize`, which inserts
    the ``Split`` fan-out layers exactly where pnnx puts them (immediately
    after the producing layer), mirroring the shipped graphs' structure.
    """

    def __init__(self) -> None:
        self.layers: List[NcnnLayer] = []
        self._blob = 0
        self._names: Dict[str, int] = {}

    def _new_blob(self) -> str:
        name = str(self._blob)
        self._blob += 1
        return name

    def _new_name(self, kind: str) -> str:
        n = self._names.get(kind, 0)
        self._names[kind] = n + 1
        return f"{kind}_{n}"

    def add(
        self,
        ltype: str,
        kind: str,
        bottoms: Sequence[str],
        attrs: Optional[Dict] = None,
        weights: Optional[Dict[str, np.ndarray]] = None,
        n_tops: int = 1,
        tops: Optional[Sequence[str]] = None,
    ):
        tops = list(tops) if tops else [self._new_blob() for _ in range(n_tops)]
        self.layers.append(
            NcnnLayer(
                ltype, self._new_name(kind), list(bottoms), tops,
                dict(attrs or {}), dict(weights or {}),
            )
        )
        return tops[0] if len(tops) == 1 else tops

    def finalize(self) -> List[NcnnLayer]:
        """Insert Split layers for every blob with >1 consumer."""
        consumers: Dict[str, int] = {}
        for layer in self.layers:
            for b in layer.bottoms:
                consumers[b] = consumers.get(b, 0) + 1
        out: List[NcnnLayer] = []
        remap: Dict[str, List[str]] = {}
        for layer in self.layers:
            layer.bottoms = [
                remap[b].pop(0) if remap.get(b) else b for b in layer.bottoms
            ]
            out.append(layer)
            for top in layer.tops:
                fan = consumers.get(top, 0)
                if fan > 1:
                    new_tops = [self._new_blob() for _ in range(fan)]
                    out.append(
                        NcnnLayer(
                            "Split", self._new_name("splitncnn"),
                            [top], new_tops, {}, {},
                        )
                    )
                    # a COPY: consumers pop from the remap queue, which must
                    # not drain the Split layer's own tops list
                    remap[top] = list(new_tops)
        return out


def _conv_attrs(
    out_c: int, k: int, stride: int, bias: bool, wsize: int,
    pad: Optional[int] = None,
) -> Dict[int, int]:
    if pad is None:
        pad = k // 2
    return {
        0: out_c, 1: k, 11: k, 12: 1, 13: stride, 14: pad,
        2: 1, 3: stride, 4: pad, 5: int(bias), 6: wsize,
    }


class _EmitterBase:
    """Shared emission vocabulary for the Ultralytics export families.

    ``sd`` is keyed by Ultralytics module path (``model.0.conv.weight`` …),
    the exact layout the ingestion-side state-dict builders produce when
    reading a real artifact — emission and ingestion are inverses by
    construction.
    """

    def __init__(self, sd: Mapping[str, np.ndarray]):
        self.sd = sd
        self.b = _Builder()

    def _conv(
        self, x: str, path: str, k: int, stride: int = 1,
        act: bool = True, pad: Optional[int] = None,
        act_op: str = "Swish",
    ) -> str:
        # ConvBN blocks key as '<path>.conv.weight' (the layout
        # ncnn_state_dict produces on ingestion); head output convs are bare
        stem = path if f"{path}.weight" in self.sd else f"{path}.conv"
        w = np.ascontiguousarray(self.sd[f"{stem}.weight"], dtype=np.float32)
        bias = self.sd.get(f"{stem}.bias")
        if w.ndim != 4 or w.shape[2] != k or w.shape[3] != k:
            raise ValueError(
                f"{path}: weight shape {w.shape} does not match kernel {k}"
            )
        weights = {"weight": w}
        if bias is not None:
            weights["bias"] = np.ascontiguousarray(bias, dtype=np.float32)
        y = self.b.add(
            "Convolution", "conv", [x],
            _conv_attrs(
                w.shape[0], k, stride, bias is not None, w.size, pad=pad
            ),
            weights,
        )
        if act:
            y = self.b.add(
                act_op, "silu" if act_op == "Swish" else act_op.lower(), [y]
            )
        return y

    def _sppf(self, x: str) -> str:
        y = self._conv(x, "model.9.cv1", 1)
        pool_attrs = {0: 0, 1: 5, 11: 5, 12: 1, 13: 2, 2: 1, 3: 2, 5: 1}
        p1 = self.b.add("Pooling", "maxpool2d", [y], pool_attrs)
        p2 = self.b.add("Pooling", "maxpool2d", [p1], pool_attrs)
        p3 = self.b.add("Pooling", "maxpool2d", [p2], pool_attrs)
        cat = self.b.add("Concat", "cat", [y, p1, p2, p3], {0: 0})
        return self._conv(cat, "model.9.cv2", 1)

    def _upsample(self, x: str) -> str:
        return self.b.add(
            "Interp", "upsample", [x], {0: 1, 1: 2.0, 2: 2.0, 6: 0}
        )

    def _dwconv(
        self, x: str, path: str, k: int, act: bool = True, stride: int = 1
    ) -> str:
        """ConvolutionDepthWise (groups = channels) — v11's pe / cls-branch
        DWConvs (yolo11 model.ncnn.param convdw_180-187) and the
        ShuffleNetV2 branch convs."""
        stem = path if f"{path}.weight" in self.sd else f"{path}.conv"
        w = np.ascontiguousarray(
            self.sd[f"{stem}.weight"], dtype=np.float32
        )
        bias = self.sd.get(f"{stem}.bias")
        out_c, pad = w.shape[0], k // 2
        attrs = {
            0: out_c, 1: k, 11: k, 12: 1, 13: stride, 14: pad,
            2: 1, 3: stride, 4: pad, 5: int(bias is not None), 6: w.size,
            7: out_c,
        }
        weights = {"weight": w}
        if bias is not None:
            weights["bias"] = np.ascontiguousarray(bias, dtype=np.float32)
        y = self.b.add(
            "ConvolutionDepthWise", "convdw", [x], attrs, weights
        )
        if act:
            y = self.b.add("Swish", "silu", [y])
        return y

    def _c3(
        self, x: str, prefix: str, n: int, residual: bool, k1: int = 1
    ) -> str:
        """C3 (v5: 1x1+3x3 bottlenecks) / C3k (v11: 3x3+3x3, ``k1=3``):
        parallel cv1/cv2 1x1s on the block input, concat, cv3."""
        cur = self._conv(x, f"{prefix}.cv1", 1)
        for j in range(n):
            t = self._conv(cur, f"{prefix}.m.{j}.cv1", k1)
            t = self._conv(t, f"{prefix}.m.{j}.cv2", 3)
            if residual:
                t = self.b.add("BinaryOp", "add", [cur, t], {0: 0})
            cur = t
        c2 = self._conv(x, f"{prefix}.cv2", 1)
        cat = self.b.add("Concat", "cat", [cur, c2], {0: 0})
        return self._conv(cat, f"{prefix}.cv3", 1)

    def _strides_md(
        self, input_size: int, strides: Sequence[int]
    ) -> str:
        """The per-anchor stride table pnnx folds to a MemoryData placed
        just before the head convs (model.ncnn.param:150 pnnx_107)."""
        from litepi_tpu_torch.ops.anchors import make_anchors

        _, strides_arr = make_anchors(input_size, strides)
        return self.b.add(
            "MemoryData", "pnnx", [], {0: strides_arr.shape[0]},
            weights={"data": strides_arr.reshape(-1).astype(np.float32)},
        )

    def _cls_branch(self, lvl: str, head: str, i: int) -> str:
        """Plain 3x3+3x3+1x1 class branch (yolo_plus/v8/v5u); v11
        overrides with its depthwise-separable form."""
        cl = self._conv(lvl, f"{head}.cv3.{i}.0", 3)
        cl = self._conv(cl, f"{head}.cv3.{i}.1", 3)
        return self._conv(cl, f"{head}.cv3.{i}.2", 1, act=False)

    def _head_decode(
        self,
        levels: Sequence[str],
        strides_md: str,
        head: str,
        reg_max: int,
        num_classes: int,
        input_size: int,
        strides: Sequence[int],
    ) -> None:
        """Decoupled head + in-graph DFL decode -> ``out0`` (4+nc, A) —
        identical across the yolo_plus/v8/v5u exports
        (model.ncnn.param:151-208)."""
        from litepi_tpu_torch.ops.anchors import make_anchors

        anchor_points, _ = make_anchors(input_size, strides)
        A = anchor_points.shape[0]
        per_level = [(input_size // s) ** 2 for s in strides]
        level_outs = []
        for i, lvl in enumerate(levels):
            r = self._conv(lvl, f"{head}.cv2.{i}.0", 3)
            r = self._conv(r, f"{head}.cv2.{i}.1", 3)
            r = self._conv(r, f"{head}.cv2.{i}.2", 1, act=False)
            cl = self._cls_branch(lvl, head, i)
            level_outs.append(self.b.add("Concat", "cat", [r, cl], {0: 0}))

        no = 4 * reg_max + num_classes
        flats = [
            self.b.add("Reshape", "reshape", [lvl], {0: npos, 1: no})
            for lvl, npos in zip(level_outs, per_level)
        ]
        full = self.b.add("Concat", "cat", flats, {0: 1})
        box, cls = self.b.add(
            "Slice", "split", [full],
            {0: [4 * reg_max, num_classes], 1: 0}, n_tops=2,
        )
        t = self.b.add(
            "Reshape", "reshape", [box], {0: A, 1: reg_max, 2: 4}
        )
        t = self.b.add("Permute", "transpose", [t], {0: 2})
        t = self.b.add("Softmax", "softmax", [t], {0: 0, 1: 1})
        dfl_w = np.arange(reg_max, dtype=np.float32).reshape(
            1, reg_max, 1, 1
        )
        t = self.b.add(
            "Convolution", "conv", [t],
            _conv_attrs(1, 1, 1, False, reg_max), {"weight": dfl_w},
        )
        t = self.b.add("Reshape", "reshape", [t], {0: A, 1: 4})
        # pnnx folds the anchor table once per consumer (two MemoryData
        # layers with identical contents — model.ncnn.param:196-197)
        anchors_2a = np.ascontiguousarray(
            anchor_points.T.astype(np.float32)
        )
        anc1 = self.b.add(
            "MemoryData", "pnnx_fold_anchor_points", [], {0: A, 1: 2},
            weights={"data": anchors_2a},
        )
        anc2 = self.b.add(
            "MemoryData", "pnnx_fold_anchor_points", [], {0: A, 1: 2},
            weights={"data": anchors_2a},
        )
        lt, rb = self.b.add(
            "Slice", "chunk", [t],
            {0: [_SLICE_AUTO, _SLICE_AUTO], 1: 0}, n_tops=2,
        )
        x1y1 = self.b.add("BinaryOp", "sub", [anc1, lt], {0: 1})
        x2y2 = self.b.add("BinaryOp", "add", [anc2, rb], {0: 0})
        csum = self.b.add("BinaryOp", "add", [x1y1, x2y2], {0: 0})
        centre = self.b.add(
            "BinaryOp", "div", [csum], {0: 3, 1: 1, 2: 2.0}
        )
        wh = self.b.add("BinaryOp", "sub", [x2y2, x1y1], {0: 1})
        xywh = self.b.add("Concat", "cat", [centre, wh], {0: 0})
        smd = self.b.add("Reshape", "reshape", [strides_md], {0: A, 1: 1})
        boxes = self.b.add("BinaryOp", "mul", [xywh, smd], {0: 2})
        scores = self.b.add("Sigmoid", "sigmoid", [cls])
        self.b.add("Concat", "cat", [boxes, scores], {0: 0}, tops=["out0"])


class _GraphEmitter(_EmitterBase):
    """yolo_plus/v8 family (C2f backbone+PAN, Detect at model.22)."""

    def __init__(self, cfg: DetectorConfig, sd: Mapping[str, np.ndarray]):
        super().__init__(sd)
        self.cfg = cfg

    def _c2f(
        self, x: str, prefix: str, out_c: int, n: int, residual: bool
    ) -> str:
        h = out_c // 2
        y = self._conv(x, f"{prefix}.cv1", 1)
        half0, half1 = self.b.add(
            "Slice", "split", [y], {0: [h, h], 1: 0}, n_tops=2
        )
        parts = [half0, half1]
        cur = half1
        for j in range(n):
            t = self._conv(cur, f"{prefix}.m.{j}.cv1", 3)
            t = self._conv(t, f"{prefix}.m.{j}.cv2", 3)
            if residual:
                t = self.b.add("BinaryOp", "add", [cur, t], {0: 0})
            parts.append(t)
            cur = t
        cat = self.b.add("Concat", "cat", parts, {0: 0})
        return self._conv(cat, f"{prefix}.cv2", 1)

    def build(self) -> List[NcnnLayer]:
        cfg = self.cfg
        c, d = cfg.channels, cfg.depths
        n_neck = d[0]
        sc = cfg.neck_shortcut

        x = self.b.add("Input", "in", [], tops=["in0"])
        x = self._conv(x, "model.0", 3, 2)
        x = self._conv(x, "model.1", 3, 2)
        x = self._c2f(x, "model.2", c[1], d[0], True)
        x = self._conv(x, "model.3", 3, 2)
        p3 = self._c2f(x, "model.4", c[2], d[1], True)
        x = self._conv(p3, "model.5", 3, 2)
        p4 = self._c2f(x, "model.6", c[3], d[2], True)
        x = self._conv(p4, "model.7", 3, 2)
        x = self._c2f(x, "model.8", c[4], d[3], True)
        p5 = self._sppf(x)

        up = self._upsample(p5)
        t4 = self.b.add("Concat", "cat", [up, p4], {0: 0})
        t4 = self._c2f(t4, "model.12", c[3], n_neck, sc)
        up = self._upsample(t4)
        t3 = self.b.add("Concat", "cat", [up, p3], {0: 0})
        n3 = self._c2f(t3, "model.15", c[2], n_neck, sc)
        dconv = self._conv(n3, "model.16", 3, 2)
        b4 = self.b.add("Concat", "cat", [dconv, t4], {0: 0})
        n4 = self._c2f(b4, "model.18", c[3], n_neck, sc)
        dconv = self._conv(n4, "model.19", 3, 2)
        b5 = self.b.add("Concat", "cat", [dconv, p5], {0: 0})
        n5 = self._c2f(b5, "model.21", c[4], n_neck, sc)

        strides_md = self._strides_md(cfg.input_size, cfg.strides)
        self._head_decode(
            (n3, n4, n5), strides_md, "model.22", cfg.reg_max,
            cfg.num_classes, cfg.input_size, cfg.strides,
        )
        return self.b.finalize()


class _V5uEmitter(_EmitterBase):
    """yolov5nu (v5 C3 body, v8 DFL head at model.24 — the deployed
    'yolo5' baseline, src/*/convert/model/yolo5/yolo5_ncnn_model/)."""

    CHANNELS = (16, 32, 64, 128, 256)
    DEPTHS = (1, 2, 3, 1)

    def __init__(
        self,
        sd: Mapping[str, np.ndarray],
        num_classes: int = 1,
        input_size: int = 640,
    ):
        super().__init__(sd)
        self.num_classes = num_classes
        self.input_size = input_size

    def build(self) -> List[NcnnLayer]:
        d = self.DEPTHS

        x = self.b.add("Input", "in", [], tops=["in0"])
        # Ultralytics' v5 stem is Conv(3, c1, k=6, s=2, p=2) — explicit
        # pad 2, not the k//2=3 autopad (yolo5 model.ncnn.param:4 "4=2")
        x = self._conv(x, "model.0", 6, 2, pad=2)
        x = self._conv(x, "model.1", 3, 2)
        x = self._c3(x, "model.2", d[0], True)
        x = self._conv(x, "model.3", 3, 2)
        p3 = self._c3(x, "model.4", d[1], True)
        x = self._conv(p3, "model.5", 3, 2)
        p4 = self._c3(x, "model.6", d[2], True)
        x = self._conv(p4, "model.7", 3, 2)
        x = self._c3(x, "model.8", d[3], True)
        p5 = self._sppf(x)

        y10 = self._conv(p5, "model.10", 1)
        up = self._upsample(y10)
        t4 = self.b.add("Concat", "cat", [up, p4], {0: 0})
        t4 = self._c3(t4, "model.13", 1, False)
        y14 = self._conv(t4, "model.14", 1)
        up = self._upsample(y14)
        t3 = self.b.add("Concat", "cat", [up, p3], {0: 0})
        n3 = self._c3(t3, "model.17", 1, False)
        dconv = self._conv(n3, "model.18", 3, 2)
        b4 = self.b.add("Concat", "cat", [dconv, y14], {0: 0})
        n4 = self._c3(b4, "model.20", 1, False)
        dconv = self._conv(n4, "model.21", 3, 2)
        b5 = self.b.add("Concat", "cat", [dconv, y10], {0: 0})
        n5 = self._c3(b5, "model.23", 1, False)

        strides_md = self._strides_md(self.input_size, (8, 16, 32))
        self._head_decode(
            (n3, n4, n5), strides_md, "model.24", 16,
            self.num_classes, self.input_size, (8, 16, 32),
        )
        return self.b.finalize()


class _V11Emitter(_EmitterBase):
    """yolov11n (C3k2 body, C2PSA attention, depthwise-separable cls head
    at model.23 — src/*/convert/model/yolo11/yolo11_ncnn_model/)."""

    DIM = 128  # C2PSA channel width (v11n P5 width // 2)

    def __init__(
        self,
        sd: Mapping[str, np.ndarray],
        num_classes: int = 1,
        input_size: int = 640,
    ):
        super().__init__(sd)
        self.num_classes = num_classes
        self.input_size = input_size

    def _c3k2(self, x: str, prefix: str, n: int, c3k: bool) -> str:
        # C2f-shaped: cv1 -> slice halves -> m chain -> concat -> cv2;
        # m is a full C3k block (3x3+3x3 bottlenecks) or one half-expansion
        # residual bottleneck (hidden derived from the cv1 weight)
        h = self.sd[f"{prefix}.cv1.conv.weight"].shape[0] // 2
        y = self._conv(x, f"{prefix}.cv1", 1)
        a, bhalf = self.b.add(
            "Slice", "split", [y], {0: [h, h], 1: 0}, n_tops=2
        )
        parts = [a, bhalf]
        cur = bhalf
        for j in range(n):
            if c3k:
                t = self._c3(cur, f"{prefix}.m.{j}", 2, True, k1=3)
            else:
                t = self._conv(cur, f"{prefix}.m.{j}.cv1", 3)
                t = self._conv(t, f"{prefix}.m.{j}.cv2", 3)
                t = self.b.add("BinaryOp", "add", [cur, t], {0: 0})
            parts.append(t)
            cur = t
        cat = self.b.add("Concat", "cat", parts, {0: 0})
        return self._conv(cat, f"{prefix}.cv2", 1)

    def _attention(self, x: str, prefix: str) -> str:
        """Ultralytics Attention as pnnx flattens it (yolo11
        model.ncnn.param:108-120): qkv conv -> (nh, 2*kd+hd, N) reshape ->
        q/k/v slice -> qT@k -> scale -> softmax -> v@attnT -> spatial
        reshape + depthwise positional conv -> proj."""
        dim = self.DIM
        nh = max(dim // 64, 1)
        hd = dim // nh
        kd = hd // 2
        size = self.input_size // 32
        N = size * size

        qkv = self._conv(x, f"{prefix}.qkv", 1, act=False)
        t = self.b.add(
            "Reshape", "reshape", [qkv], {0: N, 1: 2 * kd + hd, 2: nh}
        )
        q, k, v = self.b.add(
            "Slice", "split", [t], {0: [kd, kd, hd], 1: 1}, n_tops=3
        )
        qt = self.b.add("Permute", "transpose", [q], {0: 1})
        scores = self.b.add("MatMul", "matmul", [qt, k], {})
        # pnnx prints the folded 1/sqrt(kd) scale at 6 significant digits
        scale = float(f"{kd ** -0.5:.6g}")
        scores = self.b.add(
            "BinaryOp", "mul", [scores], {0: 2, 1: 1, 2: scale}
        )
        scores = self.b.add("Softmax", "softmax", [scores], {0: 2, 1: 1})
        o = self.b.add("MatMul", "matmultransb", [v, scores], {0: 1})
        o = self.b.add(
            "Reshape", "reshape", [o], {0: size, 1: size, 2: dim}
        )
        pe_in = self.b.add(
            "Reshape", "reshape", [v], {0: size, 1: size, 2: dim}
        )
        pe = self._dwconv(pe_in, f"{prefix}.pe", 3, act=False)
        o = self.b.add("BinaryOp", "add", [o, pe], {0: 0})
        return self._conv(o, f"{prefix}.proj", 1, act=False)

    def _c2psa(self, x: str, prefix: str) -> str:
        dim = self.DIM
        y = self._conv(x, f"{prefix}.cv1", 1)
        a, bhalf = self.b.add(
            "Slice", "split", [y], {0: [dim, dim], 1: 0}, n_tops=2
        )
        attn = self._attention(bhalf, f"{prefix}.m.0.attn")
        t = self.b.add("BinaryOp", "add", [bhalf, attn], {0: 0})
        ffn = self._conv(t, f"{prefix}.m.0.ffn.0", 1)
        ffn = self._conv(ffn, f"{prefix}.m.0.ffn.1", 1, act=False)
        t = self.b.add("BinaryOp", "add", [t, ffn], {0: 0})
        cat = self.b.add("Concat", "cat", [a, t], {0: 0})
        return self._conv(cat, f"{prefix}.cv2", 1)

    def _cls_branch(self, lvl: str, head: str, i: int) -> str:
        cl = self._dwconv(lvl, f"{head}.cv3.{i}.0.0", 3)
        cl = self._conv(cl, f"{head}.cv3.{i}.0.1", 1)
        cl = self._dwconv(cl, f"{head}.cv3.{i}.1.0", 3)
        cl = self._conv(cl, f"{head}.cv3.{i}.1.1", 1)
        return self._conv(cl, f"{head}.cv3.{i}.2", 1, act=False)

    def build(self) -> List[NcnnLayer]:
        x = self.b.add("Input", "in", [], tops=["in0"])
        x = self._conv(x, "model.0", 3, 2)
        x = self._conv(x, "model.1", 3, 2)
        x = self._c3k2(x, "model.2", 1, False)
        x = self._conv(x, "model.3", 3, 2)
        p3 = self._c3k2(x, "model.4", 1, False)
        x = self._conv(p3, "model.5", 3, 2)
        p4 = self._c3k2(x, "model.6", 1, True)
        x = self._conv(p4, "model.7", 3, 2)
        x = self._c3k2(x, "model.8", 1, True)
        x = self._sppf(x)
        p5 = self._c2psa(x, "model.10")

        up = self._upsample(p5)
        t4 = self.b.add("Concat", "cat", [up, p4], {0: 0})
        t4 = self._c3k2(t4, "model.13", 1, False)
        up = self._upsample(t4)
        t3 = self.b.add("Concat", "cat", [up, p3], {0: 0})
        n3 = self._c3k2(t3, "model.16", 1, False)
        dconv = self._conv(n3, "model.17", 3, 2)
        b4 = self.b.add("Concat", "cat", [dconv, t4], {0: 0})
        n4 = self._c3k2(b4, "model.19", 1, False)
        dconv = self._conv(n4, "model.20", 3, 2)
        b5 = self.b.add("Concat", "cat", [dconv, p5], {0: 0})
        n5 = self._c3k2(b5, "model.22", 1, True)

        strides_md = self._strides_md(self.input_size, (8, 16, 32))
        self._head_decode(
            (n3, n4, n5), strides_md, "model.23", 16,
            self.num_classes, self.input_size, (8, 16, 32),
        )
        return self.b.finalize()


class _ShuffleNetV2Emitter(_EmitterBase):
    """ShuffleNetV2 x1.0 — the reference's chosen classifier, which its
    convert-model-classify.ipynb exports to NCNN via pnnx (cell 8,
    ``inputshape=[1,3,64,64]``).  No classifier artifact survives the
    upstream blob strip, so the emitted structure is validated by forward
    parity through the graph interpreter instead of a shipped-file diff.

    ``sd`` is keyed torchvision-style (``conv1.0.weight`` …), the fused
    layout :func:`shufflenetv2_fused_state_dict` produces.
    """

    def __init__(
        self,
        sd: Mapping[str, np.ndarray],
        num_classes: int,
        stage_repeats=(4, 8, 4),
    ):
        super().__init__(sd)
        self.num_classes = num_classes
        self.stage_repeats = stage_repeats

    def _unit(self, x: str, prefix: str, stride: int) -> str:
        def branch2(inp: str) -> str:
            y = self._conv(inp, f"{prefix}.branch2.0", 1, act_op="ReLU")
            y = self._dwconv(
                y, f"{prefix}.branch2.3", 3, act=False, stride=stride
            )
            return self._conv(y, f"{prefix}.branch2.5", 1, act_op="ReLU")

        if stride == 1:
            c_half = self.sd[f"{prefix}.branch2.0.weight"].shape[1]
            a, bhalf = self.b.add(
                "Slice", "split", [x], {0: [c_half, c_half], 1: 0},
                n_tops=2,
            )
            out = self.b.add(
                "Concat", "cat", [a, branch2(bhalf)], {0: 0}
            )
        else:
            b1 = self._dwconv(
                x, f"{prefix}.branch1.0", 3, act=False, stride=2
            )
            b1 = self._conv(b1, f"{prefix}.branch1.2", 1, act_op="ReLU")
            out = self.b.add("Concat", "cat", [b1, branch2(x)], {0: 0})
        return self.b.add("ShuffleChannel", "shufflechannel", [out], {0: 2})

    def build(self) -> List[NcnnLayer]:
        x = self.b.add("Input", "in", [], tops=["in0"])
        x = self._conv(x, "conv1.0", 3, 2, act_op="ReLU")
        x = self.b.add(
            "Pooling", "maxpool2d", [x],
            {0: 0, 1: 3, 11: 3, 12: 2, 13: 1, 2: 2, 3: 1, 5: 1},
        )
        for s, reps in zip((2, 3, 4), self.stage_repeats):
            x = self._unit(x, f"stage{s}.0", 2)
            for i in range(1, reps):
                x = self._unit(x, f"stage{s}.{i}", 1)
        x = self._conv(x, "conv5.0", 1, act_op="ReLU")
        x = self.b.add("Pooling", "gap", [x], {0: 1, 4: 1})
        w = np.ascontiguousarray(self.sd["fc.weight"], dtype=np.float32)
        self.b.add(
            "InnerProduct", "linear", [x],
            {0: self.num_classes, 1: 1, 2: w.size},
            {
                "weight": w,
                "bias": np.ascontiguousarray(
                    self.sd["fc.bias"], dtype=np.float32
                ),
            },
            tops=["out0"],
        )
        return self.b.finalize()


def build_detector_graph(
    cfg: DetectorConfig, sd: Mapping[str, np.ndarray]
) -> List[NcnnLayer]:
    """Fused state dict + config -> complete NCNN layer list (with weights
    attached), structurally identical to the reference's shipped exports.

    The result always passes the ingestion-side
    :func:`~litepi_tpu_torch.weights.ncnn_import.verify_ncnn_topology` — asserted
    here so an export can never produce a graph its own loader rejects.
    """
    layers = _GraphEmitter(cfg, sd).build()
    verify_ncnn_topology(layers, cfg)
    return layers


def build_variant_graph(
    variant: str,
    sd: Mapping[str, np.ndarray],
    num_classes: int = 1,
    input_size: int = 640,
) -> List[NcnnLayer]:
    """Baseline-variant fused state dict -> NCNN layer list, verified
    against the variant's canonical emission plan (the same checker the
    ingestion side runs on the real yolo5 exports)."""
    from litepi_tpu_torch.weights.ncnn_import import verify_ncnn_variant_topology

    emitters = {"yolov5nu": _V5uEmitter, "yolov11n": _V11Emitter}
    if variant not in emitters:
        raise ValueError(
            f"unknown variant {variant!r}; choices: {sorted(emitters)}"
        )
    layers = emitters[variant](sd, num_classes, input_size).build()
    verify_ncnn_variant_topology(layers, variant, num_classes, input_size)
    return layers


# --------------------------------------------------------------------------- #
# serialization
# --------------------------------------------------------------------------- #


def _fmt_attr_value(v) -> str:
    if isinstance(v, float):
        return f"{v:.1f}" if float(v).is_integer() else repr(v)
    return str(v)


def ncnn_param_text(layers: Sequence[NcnnLayer]) -> str:
    """Render layers as ``.param`` graph text (magic 7767517, the format
    :func:`~litepi_tpu_torch.weights.ncnn_import.parse_ncnn_param` reads and the
    NCNN runtime loads)."""
    blobs = {"in0"}
    for layer in layers:
        blobs.update(layer.tops)
    lines = ["7767517", f"{len(layers)} {len(blobs)}"]
    for layer in layers:
        toks = [
            f"{layer.type:<24} {layer.name:<24}",
            str(len(layer.bottoms)), str(len(layer.tops)),
            *layer.bottoms, *layer.tops,
        ]
        for key in sorted(layer.attrs, key=str):
            val = layer.attrs[key]
            if isinstance(val, (list, tuple)):
                body = ",".join(_fmt_attr_value(v) for v in val)
                toks.append(f"{-(23300 + key)}={len(val)},{body}")
            else:
                toks.append(f"{key}={_fmt_attr_value(val)}")
        lines.append(" ".join(toks))
    return "\n".join(lines) + "\n"


def ncnn_bin_bytes(
    layers: Sequence[NcnnLayer], dtype: str = "fp32"
) -> bytes:
    """Serialize attached weights in declaration order (the flat layout
    :func:`~litepi_tpu_torch.weights.ncnn_import.read_ncnn_bin` reads back).

    ``dtype='fp16'`` stores conv weights half-precision with the NCNN tag
    + 4-byte alignment (the reference's shipped bins use this); biases and
    MemoryData stay fp32 either way, as NCNN requires.
    """
    if dtype not in ("fp32", "fp16"):
        raise ValueError(f"dtype must be fp32|fp16, got {dtype!r}")
    buf = bytearray()
    for layer in layers:
        if layer.type in (
            "Convolution", "ConvolutionDepthWise", "InnerProduct"
        ):
            w = np.ascontiguousarray(
                layer.weights["weight"], dtype=np.float32
            )
            if dtype == "fp16":
                buf += np.asarray([_TAG_FP16], dtype="<u4").tobytes()
                buf += w.astype("<f2").tobytes()
                if (2 * w.size) % 4:
                    buf += b"\x00\x00"
            else:
                buf += np.asarray([0], dtype="<u4").tobytes()
                buf += w.astype("<f4").tobytes()
            # bias_term is attr 5 for convs, attr 1 for InnerProduct
            bias_key = 1 if layer.type == "InnerProduct" else 5
            if int(layer.attr(bias_key, 0)):
                buf += np.ascontiguousarray(
                    layer.weights["bias"], dtype="<f4"
                ).tobytes()
        elif layer.type == "MemoryData":
            buf += np.ascontiguousarray(
                layer.weights["data"], dtype="<f4"
            ).tobytes()
    return bytes(buf)


# --------------------------------------------------------------------------- #
# Flax variables -> fused state dict (inverse of torch_import)
# --------------------------------------------------------------------------- #


def _put_torch_conv(
    sd: Dict[str, np.ndarray],
    dst: str,
    conv_node: Dict,
    chan_perm: Optional[np.ndarray] = None,
) -> None:
    """Write one folded Flax conv node into ``sd`` in torch layout:
    kernel (kh, kw, I, O) -> ``dst.weight`` (O, I, kh, kw) + optional
    ``dst.bias``; ``chan_perm`` re-orders output channels (the v11 qkv
    heads-major re-packing).  Single source for all four fused-state-dict
    builders."""
    k = np.asarray(conv_node["kernel"], dtype=np.float32)
    w = np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))
    b = (
        np.asarray(conv_node["bias"], dtype=np.float32)
        if "bias" in conv_node else None
    )
    if chan_perm is not None:
        w = w[chan_perm]
        if b is not None:
            b = b[chan_perm]
    sd[f"{dst}.weight"] = w
    if b is not None:
        sd[f"{dst}.bias"] = b


def _tree_node(params: Dict, *path):
    node = params
    for k in path:
        node = node[k]
    return node


def detector_fused_state_dict(
    variables: Dict, cfg: DetectorConfig
) -> Dict[str, np.ndarray]:
    """YoloLitePi variables -> BN-folded Ultralytics-keyed state dict.

    The exact inverse of :func:`litepi_tpu_torch.weights.torch_import.
    convert_detector_state_dict` composed with BN folding: training-form
    variables (conv + batch_stats) are folded to deploy form first, then
    every Flax kernel (kh, kw, I, O) transposes back to torch (O, I, kh,
    kw).  Keys/layout match what ingesting a real artifact produces, so
    export∘ingest is the identity on fp32 weights.
    """
    from litepi_tpu_torch.weights.fold_bn import fold_detector_pipeline_vars

    folded, fused = fold_detector_pipeline_vars(variables)
    if not fused:
        raise ValueError(
            "variables carry BatchNorm params without running stats — "
            "cannot fold to deploy form for export"
        )
    p = folded["params"]
    sd: Dict[str, np.ndarray] = {}

    def put(dst: str, conv_node: Dict) -> None:
        _put_torch_conv(sd, dst, conv_node)

    def conv_bn(dst: str, *path) -> None:
        # '.conv' stem matches the ingestion-side ncnn_state_dict keying
        put(f"{dst}.conv", _tree_node(p, *path, "conv"))

    def c2f(dst: str, flax: str, scope: tuple, n: int) -> None:
        conv_bn(f"{dst}.cv1", *scope, flax, "cv1")
        conv_bn(f"{dst}.cv2", *scope, flax, "cv2")
        for i in range(n):
            conv_bn(f"{dst}.m.{i}.cv1", *scope, flax, f"m{i}", "cv1")
            conv_bn(f"{dst}.m.{i}.cv2", *scope, flax, f"m{i}", "cv2")

    d = cfg.depths
    bb = ("backbone",)
    conv_bn("model.0", *bb, "stem")
    conv_bn("model.1", *bb, "down1")
    c2f("model.2", "c2f1", bb, d[0])
    conv_bn("model.3", *bb, "down2")
    c2f("model.4", "c2f2", bb, d[1])
    conv_bn("model.5", *bb, "down3")
    c2f("model.6", "c2f3", bb, d[2])
    conv_bn("model.7", *bb, "down4")
    c2f("model.8", "c2f4", bb, d[3])
    conv_bn("model.9.cv1", *bb, "sppf", "cv1")
    conv_bn("model.9.cv2", *bb, "sppf", "cv2")

    nk = ("neck",)
    c2f("model.12", "td_p4", nk, d[0])
    c2f("model.15", "td_p3", nk, d[0])
    conv_bn("model.16", *nk, "bu_down3")
    c2f("model.18", "bu_p4", nk, d[0])
    conv_bn("model.19", *nk, "bu_down4")
    c2f("model.21", "bu_p5", nk, d[0])

    for i in range(3):
        conv_bn(f"model.22.cv2.{i}.0", "head", f"reg{i}_cv1")
        conv_bn(f"model.22.cv2.{i}.1", "head", f"reg{i}_cv2")
        put(f"model.22.cv2.{i}.2", _tree_node(p, "head", f"reg{i}_out"))
        conv_bn(f"model.22.cv3.{i}.0", "head", f"cls{i}_cv1")
        conv_bn(f"model.22.cv3.{i}.1", "head", f"cls{i}_cv2")
        put(f"model.22.cv3.{i}.2", _tree_node(p, "head", f"cls{i}_out"))
    return sd


def yolov5u_fused_state_dict(variables: Dict) -> Dict[str, np.ndarray]:
    """YoloV5(anchor_free=True) variables -> BN-folded Ultralytics-keyed
    state dict — the exact inverse of :func:`litepi_tpu_torch.weights.
    torch_import.convert_yolov5u_state_dict` composed with BN folding."""
    from litepi_tpu_torch.weights.fold_bn import fold_detector_pipeline_vars

    folded, fused = fold_detector_pipeline_vars(variables)
    if not fused:
        raise ValueError(
            "variables carry BatchNorm params without running stats — "
            "cannot fold to deploy form for export"
        )
    p = folded["params"]
    sd: Dict[str, np.ndarray] = {}

    def put(dst: str, conv_node: Dict) -> None:
        _put_torch_conv(sd, dst, conv_node)

    def conv_bn(dst: str, *path) -> None:
        put(f"{dst}.conv", _tree_node(p, *path, "conv"))

    def c3(dst: str, flax: str, n: int) -> None:
        conv_bn(f"{dst}.cv1", flax, "cv1")
        conv_bn(f"{dst}.cv2", flax, "cv2")
        conv_bn(f"{dst}.cv3", flax, "cv3")
        for i in range(n):
            conv_bn(f"{dst}.m.{i}.cv1", flax, f"m{i}", "cv1")
            conv_bn(f"{dst}.m.{i}.cv2", flax, f"m{i}", "cv2")

    conv_bn("model.0", "stem")
    conv_bn("model.1", "down1")
    c3("model.2", "c3_1", 1)
    conv_bn("model.3", "down2")
    c3("model.4", "c3_2", 2)
    conv_bn("model.5", "down3")
    c3("model.6", "c3_3", 3)
    conv_bn("model.7", "down4")
    c3("model.8", "c3_4", 1)
    conv_bn("model.9.cv1", "sppf", "cv1")
    conv_bn("model.9.cv2", "sppf", "cv2")
    conv_bn("model.10", "td_cv5")
    c3("model.13", "td_p4", 1)
    conv_bn("model.14", "td_cv4")
    c3("model.17", "td_p3", 1)
    conv_bn("model.18", "bu_down3")
    c3("model.20", "bu_p4", 1)
    conv_bn("model.21", "bu_down4")
    c3("model.23", "bu_p5", 1)
    for i in range(3):
        conv_bn(f"model.24.cv2.{i}.0", f"reg{i}_cv1")
        conv_bn(f"model.24.cv2.{i}.1", f"reg{i}_cv2")
        put(f"model.24.cv2.{i}.2", p[f"reg{i}_out"])
        conv_bn(f"model.24.cv3.{i}.0", f"cls{i}_cv1")
        conv_bn(f"model.24.cv3.{i}.1", f"cls{i}_cv2")
        put(f"model.24.cv3.{i}.2", p[f"cls{i}_out"])
    return sd


def yolov11_fused_state_dict(variables: Dict) -> Dict[str, np.ndarray]:
    """YoloV11 variables -> BN-folded Ultralytics-keyed state dict — the
    inverse of :func:`litepi_tpu_torch.weights.torch_import.
    convert_yolov11_state_dict` composed with BN folding.  The attention
    qkv conv's output channels are re-packed from our branch-major split
    back to torch's heads-major layout (the inverse permutation of
    ``_qkv_permutation``)."""
    from litepi_tpu_torch.weights.fold_bn import fold_detector_pipeline_vars
    from litepi_tpu_torch.weights.torch_import import _qkv_permutation

    folded, fused = fold_detector_pipeline_vars(variables)
    if not fused:
        raise ValueError(
            "variables carry BatchNorm params without running stats — "
            "cannot fold to deploy form for export"
        )
    p = folded["params"]
    sd: Dict[str, np.ndarray] = {}

    def put(dst: str, conv_node: Dict, chan_perm=None) -> None:
        _put_torch_conv(sd, dst, conv_node, chan_perm)

    def conv_bn(dst: str, *path, chan_perm=None) -> None:
        put(f"{dst}.conv", _tree_node(p, *path, "conv"), chan_perm)

    def c3k2(dst: str, flax: str, n: int, c3k: bool) -> None:
        conv_bn(f"{dst}.cv1", flax, "cv1")
        conv_bn(f"{dst}.cv2", flax, "cv2")
        for i in range(n):
            if c3k:
                conv_bn(f"{dst}.m.{i}.cv1", flax, f"m{i}", "cv1")
                conv_bn(f"{dst}.m.{i}.cv2", flax, f"m{i}", "cv2")
                conv_bn(f"{dst}.m.{i}.cv3", flax, f"m{i}", "cv3")
                for j in range(2):
                    conv_bn(
                        f"{dst}.m.{i}.m.{j}.cv1", flax, f"m{i}", f"m{j}", "cv1"
                    )
                    conv_bn(
                        f"{dst}.m.{i}.m.{j}.cv2", flax, f"m{i}", f"m{j}", "cv2"
                    )
            else:
                conv_bn(f"{dst}.m.{i}.cv1", flax, f"m{i}", "cv1")
                conv_bn(f"{dst}.m.{i}.cv2", flax, f"m{i}", "cv2")

    conv_bn("model.0", "stem")
    conv_bn("model.1", "down1")
    c3k2("model.2", "c3k2_1", 1, False)
    conv_bn("model.3", "down2")
    c3k2("model.4", "c3k2_2", 1, False)
    conv_bn("model.5", "down3")
    c3k2("model.6", "c3k2_3", 1, True)
    conv_bn("model.7", "down4")
    c3k2("model.8", "c3k2_4", 1, True)
    conv_bn("model.9.cv1", "sppf", "cv1")
    conv_bn("model.9.cv2", "sppf", "cv2")

    conv_bn("model.10.cv1", "c2psa", "cv1")
    dim = np.asarray(
        p["c2psa"]["m0"]["attn"]["proj"]["conv"]["kernel"]
    ).shape[-1]
    nh = max(dim // 64, 1)
    head_dim = dim // nh
    perm = _qkv_permutation(nh, head_dim // 2, head_dim)
    inv = np.argsort(perm)
    conv_bn(
        "model.10.m.0.attn.qkv", "c2psa", "m0", "attn", "qkv", chan_perm=inv
    )
    conv_bn("model.10.m.0.attn.pe", "c2psa", "m0", "attn", "pe")
    conv_bn("model.10.m.0.attn.proj", "c2psa", "m0", "attn", "proj")
    conv_bn("model.10.m.0.ffn.0", "c2psa", "m0", "ffn1")
    conv_bn("model.10.m.0.ffn.1", "c2psa", "m0", "ffn2")
    conv_bn("model.10.cv2", "c2psa", "cv2")

    c3k2("model.13", "td_p4", 1, False)
    c3k2("model.16", "td_p3", 1, False)
    conv_bn("model.17", "bu_down3")
    c3k2("model.19", "bu_p4", 1, False)
    conv_bn("model.20", "bu_down4")
    c3k2("model.22", "bu_p5", 1, True)
    for i in range(3):
        conv_bn(f"model.23.cv2.{i}.0", f"reg{i}_cv1")
        conv_bn(f"model.23.cv2.{i}.1", f"reg{i}_cv2")
        put(f"model.23.cv2.{i}.2", p[f"reg{i}_out"])
        conv_bn(f"model.23.cv3.{i}.0.0", f"cls{i}_dw1")
        conv_bn(f"model.23.cv3.{i}.0.1", f"cls{i}_pw1")
        conv_bn(f"model.23.cv3.{i}.1.0", f"cls{i}_dw2")
        conv_bn(f"model.23.cv3.{i}.1.1", f"cls{i}_pw2")
        put(f"model.23.cv3.{i}.2", p[f"cls{i}_out"])
    return sd


def shufflenetv2_fused_state_dict(
    variables: Dict, stage_repeats=(4, 8, 4)
) -> Dict[str, np.ndarray]:
    """ShuffleNetV2 variables -> BN-folded torchvision-keyed state dict —
    the inverse of ``torch_import._convert_shufflenetv2`` composed with BN
    folding (classifier ConvBN eps is CLASSIFIER_BN_EPS, not the
    detector's 1e-3)."""
    from litepi_tpu_torch.models.layers import CLASSIFIER_BN_EPS
    from litepi_tpu_torch.weights.fold_bn import fold_pipeline_vars

    folded, fused = fold_pipeline_vars(variables, eps=CLASSIFIER_BN_EPS)
    if not fused:
        raise ValueError(
            "variables carry BatchNorm params without running stats — "
            "cannot fold to deploy form for export"
        )
    p = folded["params"]
    sd: Dict[str, np.ndarray] = {}

    def put(dst: str, conv_node: Dict) -> None:
        _put_torch_conv(sd, dst, conv_node)

    put("conv1.0", p["conv1"]["conv"])
    for s, reps in zip((2, 3, 4), stage_repeats):
        for i in range(reps):
            f = p[f"stage{s}_{i}"]
            t = f"stage{s}.{i}"
            if i == 0:
                put(f"{t}.branch1.0", f["b1_dw"]["conv"])
                put(f"{t}.branch1.2", f["b1_pw"]["conv"])
            put(f"{t}.branch2.0", f["b2_pw1"]["conv"])
            put(f"{t}.branch2.3", f["b2_dw"]["conv"])
            put(f"{t}.branch2.5", f["b2_pw2"]["conv"])
    put("conv5.0", p["conv5"]["conv"])
    fc = p["fc"]
    sd["fc.weight"] = np.ascontiguousarray(
        np.asarray(fc["kernel"], dtype=np.float32).T
    )
    sd["fc.bias"] = np.asarray(fc["bias"], dtype=np.float32)
    return sd


def export_classifier_ncnn(
    arch: str,
    variables: Dict,
    num_classes: int,
    param_path: str,
    bin_path: str,
    dtype: str = "fp32",
) -> List[NcnnLayer]:
    """Classifier sibling of :func:`export_detector_ncnn` — rebuilds the
    reference's pnnx classifier export (convert-model-classify.ipynb cell
    8).  ShuffleNetV2 (the deployed choice) is emitted; the other three
    archs remain checkpoint- and program-export-only."""
    if arch != "shufflenetv2":
        raise ValueError(
            f"NCNN classifier emission covers 'shufflenetv2' (the deployed "
            f"choice); got {arch!r}"
        )
    sd = shufflenetv2_fused_state_dict(variables)
    layers = _ShuffleNetV2Emitter(sd, num_classes).build()
    _write_pair(layers, param_path, bin_path, dtype)
    return layers


# --------------------------------------------------------------------------- #
# public entry point
# --------------------------------------------------------------------------- #


def export_detector_ncnn(
    variables: Dict,
    cfg: DetectorConfig,
    param_path: str,
    bin_path: str,
    dtype: str = "fp32",
) -> List[NcnnLayer]:
    """Write a deployable NCNN ``.param``/``.bin`` pair for a yolo_plus /
    yolov8-family detector (the reference deployment's native format).

    Accepts training-form (conv+BN) or deploy-form variables; BN is folded
    either way.  Returns the emitted layer list (weights attached) so
    callers can smoke-test it through ``run_ncnn_graph`` without re-reading
    the files.
    """
    sd = detector_fused_state_dict(variables, cfg)
    layers = build_detector_graph(cfg, sd)
    _write_pair(layers, param_path, bin_path, dtype)
    return layers


def export_detector_ncnn_variant(
    variables: Dict,
    variant: str,
    param_path: str,
    bin_path: str,
    num_classes: int = 1,
    dtype: str = "fp32",
    input_size: int = 640,
) -> List[NcnnLayer]:
    """Baseline-variant sibling of :func:`export_detector_ncnn` — emits
    the yolov5nu / yolov11n graphs (the deployed baselines' exact
    structures) from YoloV5(anchor_free=True) / YoloV11 variables."""
    builders = {
        "yolov5nu": yolov5u_fused_state_dict,
        "yolov11n": yolov11_fused_state_dict,
    }
    if variant not in builders:
        raise ValueError(
            f"unknown variant {variant!r}; choices: {sorted(builders)}"
        )
    sd = builders[variant](variables)
    layers = build_variant_graph(variant, sd, num_classes, input_size)
    _write_pair(layers, param_path, bin_path, dtype)
    return layers


def _write_pair(
    layers: Sequence[NcnnLayer],
    param_path: str,
    bin_path: str,
    dtype: str,
) -> None:
    with open(param_path, "w") as f:
        f.write(ncnn_param_text(layers))
    with open(bin_path, "wb") as f:
        f.write(ncnn_bin_bytes(layers, dtype=dtype))
