"""ONNX graph emission (a protobuf writer in numpy and ``struct``).

The port's copy of the JAX package's ``weights/onnx_export.py``.  From the
Flax-named numpy trees of the port's importers and checkpoint it writes the
vocabulary of the reference's ``yolo_plus.onnx`` (opset 12, in-graph DFL
decode with folded anchor/stride constants) for the yolo_plus / yolov8n
family (:class:`_OnnxEmitter`) and the ShuffleNetV2 classifier
(:class:`_ShuffleNetV2OnnxEmitter`).  The protobuf wire format is written
directly, symmetric to the reader in
:mod:`litepi_tpu_torch.weights.onnx_import` (no ``onnx`` package).  The
bytes equal the JAX emitter's on the same tree, and the graph runs through
:func:`litepi_tpu_torch.weights.onnx_import.run_onnx_graph` (torch) to the
port's model plus decode (tests/test_torch_export_onnx_openvino.py).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from litepi_tpu_torch.core.types import DetectorConfig

# ONNX TensorProto dtype codes (mirror onnx_import._DTYPES)
_F32, _I64 = 1, 7


# --------------------------------------------------------------------------- #
# protobuf wire-format writer
# --------------------------------------------------------------------------- #


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _int_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _str_field(field: int, value: str) -> bytes:
    return _len_field(field, value.encode("utf-8"))


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    if arr.dtype == np.int64:
        code = _I64
        raw = arr.astype("<i8").tobytes()
    else:
        code = _F32
        raw = arr.astype("<f4").tobytes()
    buf = bytearray()
    for d in arr.shape:
        buf += _int_field(1, d)
    buf += _int_field(2, code)
    buf += _str_field(8, name)
    buf += _len_field(9, raw)
    return bytes(buf)


def _attr(name: str, value) -> bytes:
    buf = bytearray(_str_field(1, name))
    if isinstance(value, (list, tuple)):  # INTS
        for v in value:
            buf += _int_field(8, int(v))
        buf += _int_field(20, 7)
    elif isinstance(value, float):
        buf += _tag(2, 5) + struct.pack("<f", value)
        buf += _int_field(20, 1)
    elif isinstance(value, str):
        buf += _len_field(4, value.encode())
        buf += _int_field(20, 3)
    else:  # INT
        buf += _int_field(3, int(value))
        buf += _int_field(20, 2)
    return bytes(buf)


def _node_proto(
    op: str,
    name: str,
    inputs: Sequence[str],
    outputs: Sequence[str],
    attrs: Optional[Dict] = None,
) -> bytes:
    buf = bytearray()
    for i in inputs:
        buf += _str_field(1, i)
    for o in outputs:
        buf += _str_field(2, o)
    buf += _str_field(3, name)
    buf += _str_field(4, op)
    for k in sorted(attrs or {}):
        buf += _len_field(5, _attr(k, attrs[k]))
    return bytes(buf)


def _value_info(name: str, shape: Sequence[int]) -> bytes:
    dims = b"".join(
        _len_field(1, _int_field(1, d)) for d in shape
    )
    tensor_type = _int_field(1, _F32) + _len_field(2, dims)
    type_proto = _len_field(1, tensor_type)
    return _str_field(1, name) + _len_field(2, type_proto)


# --------------------------------------------------------------------------- #
# graph construction (yolo_plus / v8 family)
# --------------------------------------------------------------------------- #


class _OnnxEmitter:
    """Builds the Ultralytics-export node/initializer set from a fused
    state dict (the ``model.X.conv.weight`` keying all ingestion paths
    produce).  Node/initializer naming follows the real export's
    conventions so the structural tests can compare inventories."""

    def __init__(self, cfg: DetectorConfig, sd: Mapping[str, np.ndarray]):
        self.cfg = cfg
        self.sd = sd
        self.nodes: List[Tuple[str, str, List[str], List[str], Dict]] = []
        self.inits: Dict[str, np.ndarray] = {}

    def _add(self, op, name, inputs, outputs, attrs=None) -> str:
        self.nodes.append((op, name, list(inputs), list(outputs), attrs or {}))
        return outputs[0]

    def _const(self, name: str, arr: np.ndarray) -> str:
        self.inits[name] = arr
        return name

    def _conv(
        self, x: str, path: str, k: int, stride: int = 1, act: bool = True
    ) -> str:
        stem = path if f"{path}.weight" in self.sd else f"{path}.conv"
        w = np.ascontiguousarray(self.sd[f"{stem}.weight"], np.float32)
        bias = self.sd.get(f"{stem}.bias")
        # node names use the module path; the real export's exact slash
        # conventions ('/model.2/cv1/conv/Conv') differ cosmetically — the
        # structural tests compare op/attr/constant inventories, not names
        base = "/" + path
        inputs = [x, self._const(f"{stem}.weight", w)]
        if bias is not None:
            inputs.append(
                self._const(
                    f"{stem}.bias",
                    np.ascontiguousarray(bias, np.float32),
                )
            )
        pad = k // 2
        y = self._add(
            "Conv", f"{base}/Conv", inputs, [f"{base}/Conv_output_0"],
            {
                "dilations": [1, 1], "group": 1, "kernel_shape": [k, k],
                "pads": [pad, pad, pad, pad], "strides": [stride, stride],
            },
        )
        if act:
            s = self._add(
                "Sigmoid", f"{base}/act/Sigmoid", [y],
                [f"{base}/act/Sigmoid_output_0"],
            )
            y = self._add(
                "Mul", f"{base}/act/Mul", [y, s],
                [f"{base}/act/Mul_output_0"],
            )
        return y

    def _c2f(
        self, x: str, prefix: str, out_c: int, n: int, residual: bool
    ) -> str:
        h = out_c // 2
        y = self._conv(x, f"{prefix}.cv1", 1)
        base = "/" + prefix
        half0, half1 = f"{base}/Split_output_0", f"{base}/Split_output_1"
        self._add(
            "Split", f"{base}/Split", [y], [half0, half1],
            {"axis": 1, "split": [h, h]},
        )
        parts = [half0, half1]
        cur = half1
        for j in range(n):
            t = self._conv(cur, f"{prefix}.m.{j}.cv1", 3)
            t = self._conv(t, f"{prefix}.m.{j}.cv2", 3)
            if residual:
                t = self._add(
                    "Add", f"{base}/m.{j}/Add", [cur, t],
                    [f"{base}/m.{j}/Add_output_0"],
                )
            parts.append(t)
            cur = t
        cat = self._add(
            "Concat", f"{base}/Concat", parts,
            [f"{base}/Concat_output_0"], {"axis": 1},
        )
        return self._conv(cat, f"{prefix}.cv2", 1)

    def _sppf(self, x: str) -> str:
        y = self._conv(x, "model.9.cv1", 1)
        pool_attrs = {
            "ceil_mode": 0, "dilations": [1, 1], "kernel_shape": [5, 5],
            "pads": [2, 2, 2, 2], "strides": [1, 1],
        }
        p1 = self._add(
            "MaxPool", "/model.9/m/MaxPool", [y],
            ["/model.9/m/MaxPool_output_0"], pool_attrs,
        )
        p2 = self._add(
            "MaxPool", "/model.9/m_1/MaxPool", [p1],
            ["/model.9/m_1/MaxPool_output_0"], pool_attrs,
        )
        p3 = self._add(
            "MaxPool", "/model.9/m_2/MaxPool", [p2],
            ["/model.9/m_2/MaxPool_output_0"], pool_attrs,
        )
        cat = self._add(
            "Concat", "/model.9/Concat", [y, p1, p2, p3],
            ["/model.9/Concat_output_0"], {"axis": 1},
        )
        return self._conv(cat, "model.9.cv2", 1)

    def _upsample(self, x: str, idx: int) -> str:
        # both Resize nodes share one scales/roi constant pair, exactly
        # like the real export (/model.10/Constant{,_1}_output_0)
        roi = self._const(
            "/model.10/Constant_1_output_0", np.zeros((0,), np.float32)
        )
        scales = self._const(
            "/model.10/Constant_output_0",
            np.asarray([1.0, 1.0, 2.0, 2.0], np.float32),
        )
        return self._add(
            "Resize", f"/model.{idx}/Resize", [x, roi, scales],
            [f"/model.{idx}/Resize_output_0"],
            {
                "coordinate_transformation_mode": "asymmetric",
                "cubic_coeff_a": -0.75,
                "mode": "nearest",
                "nearest_mode": "floor",
            },
        )

    def build(self) -> None:
        cfg = self.cfg
        c, d = cfg.channels, cfg.depths
        n_neck = d[0]
        sc = cfg.neck_shortcut

        x = self._conv("images", "model.0", 3, 2)
        x = self._conv(x, "model.1", 3, 2)
        x = self._c2f(x, "model.2", c[1], d[0], True)
        x = self._conv(x, "model.3", 3, 2)
        p3 = self._c2f(x, "model.4", c[2], d[1], True)
        x = self._conv(p3, "model.5", 3, 2)
        p4 = self._c2f(x, "model.6", c[3], d[2], True)
        x = self._conv(p4, "model.7", 3, 2)
        x = self._c2f(x, "model.8", c[4], d[3], True)
        p5 = self._sppf(x)

        up = self._upsample(p5, 10)
        t4 = self._add(
            "Concat", "/model.11/Concat", [up, p4],
            ["/model.11/Concat_output_0"], {"axis": 1},
        )
        t4 = self._c2f(t4, "model.12", c[3], n_neck, sc)
        up = self._upsample(t4, 13)
        t3 = self._add(
            "Concat", "/model.14/Concat", [up, p3],
            ["/model.14/Concat_output_0"], {"axis": 1},
        )
        n3 = self._c2f(t3, "model.15", c[2], n_neck, sc)
        dconv = self._conv(n3, "model.16", 3, 2)
        b4 = self._add(
            "Concat", "/model.17/Concat", [dconv, t4],
            ["/model.17/Concat_output_0"], {"axis": 1},
        )
        n4 = self._c2f(b4, "model.18", c[3], n_neck, sc)
        dconv = self._conv(n4, "model.19", 3, 2)
        b5 = self._add(
            "Concat", "/model.20/Concat", [dconv, p5],
            ["/model.20/Concat_output_0"], {"axis": 1},
        )
        n5 = self._c2f(b5, "model.21", c[4], n_neck, sc)
        self._head_decode((n3, n4, n5))

    def _head_decode(self, levels: Sequence[str]) -> None:
        from litepi_tpu_torch.ops.anchors import make_anchors

        cfg = self.cfg
        reg_max, nc = cfg.reg_max, cfg.num_classes
        A = cfg.num_anchors
        anchor_points, strides_arr = make_anchors(
            cfg.input_size, cfg.strides
        )
        h = "/model.22"
        flats = []
        for i, lvl in enumerate(levels):
            r = self._conv(lvl, f"model.22.cv2.{i}.0", 3)
            r = self._conv(r, f"model.22.cv2.{i}.1", 3)
            r = self._conv(r, f"model.22.cv2.{i}.2", 1, act=False)
            cl = self._conv(lvl, f"model.22.cv3.{i}.0", 3)
            cl = self._conv(cl, f"model.22.cv3.{i}.1", 3)
            cl = self._conv(cl, f"model.22.cv3.{i}.2", 1, act=False)
            sfx = "" if i == 0 else f"_{i}"
            cat = self._add(
                "Concat", f"{h}/Concat{sfx}", [r, cl],
                [f"{h}/Concat{sfx}_output_0"], {"axis": 1},
            )
            shape = self._const(
                f"{h}/Constant_output_0",
                np.asarray([1, 4 * reg_max + nc, -1], np.int64),
            )
            flats.append(
                self._add(
                    "Reshape", f"{h}/Reshape{sfx}", [cat, shape],
                    [f"{h}/Reshape{sfx}_output_0"],
                )
            )
        full = self._add(
            "Concat", f"{h}/Concat_3", flats,
            [f"{h}/Concat_3_output_0"], {"axis": 2},
        )
        box, cls = f"{h}/Split_output_0", f"{h}/Split_output_1"
        self._add(
            "Split", f"{h}/Split", [full], [box, cls],
            {"axis": 1, "split": [4 * reg_max, nc]},
        )
        sig = self._add(
            "Sigmoid", f"{h}/Sigmoid", [cls], [f"{h}/Sigmoid_output_0"]
        )

        dfl_shape = self._const(
            f"{h}/dfl/Constant_output_0",
            np.asarray([1, 4, reg_max, A], np.int64),
        )
        t = self._add(
            "Reshape", f"{h}/dfl/Reshape", [box, dfl_shape],
            [f"{h}/dfl/Reshape_output_0"],
        )
        t = self._add(
            "Transpose", f"{h}/dfl/Transpose", [t],
            [f"{h}/dfl/Transpose_output_0"], {"perm": [0, 3, 1, 2]},
        )
        t = self._add(
            "Softmax", f"{h}/dfl/Softmax", [t],
            [f"{h}/dfl/Softmax_output_0"], {"axis": 3},
        )
        t = self._add(
            "Transpose", f"{h}/dfl/Transpose_1", [t],
            [f"{h}/dfl/Transpose_1_output_0"], {"perm": [0, 3, 2, 1]},
        )
        dfl_w = self._const(
            "model.22.dfl.conv.weight",
            np.arange(reg_max, dtype=np.float32).reshape(1, reg_max, 1, 1),
        )
        t = self._add(
            "Conv", f"{h}/dfl/conv/Conv", [t, dfl_w],
            [f"{h}/dfl/conv/Conv_output_0"],
            {
                "dilations": [1, 1], "group": 1, "kernel_shape": [1, 1],
                "pads": [0, 0, 0, 0], "strides": [1, 1],
            },
        )
        out_shape = self._const(
            f"{h}/dfl/Constant_1_output_0",
            np.asarray([1, 4, A], np.int64),
        )
        dist = self._add(
            "Reshape", f"{h}/dfl/Reshape_1", [t, out_shape],
            [f"{h}/dfl/Reshape_1_output_0"],
        )

        zero = self._const(f"{h}/Constant_4_output_0", np.asarray([0], np.int64))
        two = self._const(f"{h}/Mul_output_0", np.asarray([2], np.int64))
        axes = self._const(f"{h}/Constant_3_output_0", np.asarray([1], np.int64))
        four = self._const(f"{h}/Mul_1_output_0", np.asarray([4], np.int64))
        lt = self._add(
            "Slice", f"{h}/Slice", [dist, zero, two, axes],
            [f"{h}/Slice_output_0"],
        )
        rb = self._add(
            "Slice", f"{h}/Slice_1", [dist, two, four, axes],
            [f"{h}/Slice_1_output_0"],
        )
        anchors_12a = np.ascontiguousarray(
            anchor_points.T.astype(np.float32)
        )[None]
        anc1 = self._const(f"{h}/Constant_9_output_0", anchors_12a)
        anc2 = self._const(f"{h}/Constant_10_output_0", anchors_12a.copy())
        x1y1 = self._add(
            "Sub", f"{h}/Sub", [anc1, lt], [f"{h}/Sub_output_0"]
        )
        x2y2 = self._add(
            "Add", f"{h}/Add_1", [anc2, rb], [f"{h}/Add_1_output_0"]
        )
        csum = self._add(
            "Add", f"{h}/Add_2", [x1y1, x2y2], [f"{h}/Add_2_output_0"]
        )
        half = self._const(
            f"{h}/Constant_11_output_0", np.asarray([2.0], np.float32)
        )
        centre = self._add(
            "Div", f"{h}/Div_1", [csum, half], [f"{h}/Div_1_output_0"]
        )
        wh = self._add(
            "Sub", f"{h}/Sub_1", [x2y2, x1y1], [f"{h}/Sub_1_output_0"]
        )
        xywh = self._add(
            "Concat", f"{h}/Concat_4", [centre, wh],
            [f"{h}/Concat_4_output_0"], {"axis": 1},
        )
        strides_c = self._const(
            f"{h}/Constant_12_output_0",
            np.ascontiguousarray(strides_arr.reshape(1, -1).astype(np.float32)),
        )
        boxes = self._add(
            "Mul", f"{h}/Mul_2", [xywh, strides_c],
            [f"{h}/Mul_2_output_0"],
        )
        self._add(
            "Concat", f"{h}/Concat_5", [boxes, sig], ["output0"],
            {"axis": 1},
        )


# --------------------------------------------------------------------------- #
# serialization + public entry points
# --------------------------------------------------------------------------- #


def onnx_model_bytes(
    nodes: Sequence[Tuple],
    inits: Mapping[str, np.ndarray],
    input_shape: Sequence[int],
    output_shape: Sequence[int],
    input_name: str = "images",
    output_name: str = "output0",
) -> bytes:
    """Assemble ModelProto bytes (ir 7 / opset 12, the real export's
    versions — yolo_plus.onnx header)."""
    graph = bytearray()
    for op, name, inputs, outputs, attrs in nodes:
        graph += _len_field(1, _node_proto(op, name, inputs, outputs, attrs))
    graph += _str_field(2, "main_graph")
    for name, arr in inits.items():
        graph += _len_field(5, _tensor_proto(name, arr))
    graph += _len_field(11, _value_info(input_name, input_shape))
    graph += _len_field(12, _value_info(output_name, output_shape))

    model = bytearray()
    model += _int_field(1, 7)  # ir_version
    model += _str_field(2, "litepi_tpu")
    model += _len_field(7, bytes(graph))
    model += _len_field(8, _int_field(2, 12))  # opset_import {version: 12}
    return bytes(model)


def build_detector_onnx(
    cfg: DetectorConfig, sd: Mapping[str, np.ndarray]
) -> bytes:
    """Fused state dict + config -> complete ONNX model bytes (yolo_plus /
    v8 family, in-graph decode, ``images`` -> ``output0``)."""
    em = _OnnxEmitter(cfg, sd)
    em.build()
    return onnx_model_bytes(
        em.nodes,
        em.inits,
        (1, 3, cfg.input_size, cfg.input_size),
        (1, 4 + cfg.num_classes, cfg.num_anchors),
    )


def export_detector_onnx(
    variables: Dict, cfg: DetectorConfig, path: str
) -> bytes:
    """Write a deployable ``.onnx`` for a yolo_plus/v8-family detector —
    the reference's interchange format (its NCNN/OpenVINO artifacts are
    converted FROM this).  Accepts training- or deploy-form variables."""
    from litepi_tpu_torch.weights.ncnn_export import detector_fused_state_dict

    sd = detector_fused_state_dict(variables, cfg)
    data = build_detector_onnx(cfg, sd)
    with open(path, "wb") as f:
        f.write(data)
    return data


# --------------------------------------------------------------------------- #
# classifier emission (ShuffleNetV2 — the deployed choice)
# --------------------------------------------------------------------------- #


class _ShuffleNetV2OnnxEmitter:
    """ShuffleNetV2 x1.0 deploy-form ONNX emission — the classifier leg
    of the reference's export flow, which runs torch.onnx.export BEFORE
    the NCNN/OpenVINO conversions (convert-model-classify.ipynb cell 3).
    No classifier ONNX survives the upstream blob strip, so the emitted
    vocabulary is the fused eval-mode trace (Conv+Relu incl. grouped
    depthwise, Split halves, the Reshape/Transpose/Reshape channel
    shuffle, ReduceMean spatial mean, Gemm) and validation is interpreter
    forward parity + re-ingestion (tests/test_onnx_export.py).

    ``sd`` is keyed torchvision-style (``conv1.0.weight`` …), the fused
    layout :func:`litepi_tpu_torch.weights.ncnn_export.
    shufflenetv2_fused_state_dict` produces.
    """

    def __init__(
        self,
        sd: Mapping[str, np.ndarray],
        num_classes: int,
        input_size: int = 64,
        stage_repeats=(4, 8, 4),
    ):
        self.sd = sd
        self.num_classes = num_classes
        self.input_size = input_size
        self.stage_repeats = stage_repeats
        self.nodes: List[Tuple[str, str, List[str], List[str], Dict]] = []
        self.inits: Dict[str, np.ndarray] = {}

    def _add(self, op, name, inputs, outputs, attrs=None) -> str:
        self.nodes.append((op, name, list(inputs), list(outputs), attrs or {}))
        return outputs[0]

    def _const(self, name: str, arr: np.ndarray) -> str:
        self.inits[name] = arr
        return name

    def _conv(
        self, x: str, path: str, k: int, stride: int = 1,
        act: bool = True, groups: int = 1,
    ) -> str:
        w = np.ascontiguousarray(self.sd[f"{path}.weight"], np.float32)
        base = "/" + path
        inputs = [x, self._const(f"{path}.weight", w)]
        bias = self.sd.get(f"{path}.bias")
        if bias is not None:
            inputs.append(
                self._const(
                    f"{path}.bias", np.ascontiguousarray(bias, np.float32)
                )
            )
        pad = k // 2
        y = self._add(
            "Conv", f"{base}/Conv", inputs, [f"{base}/Conv_output_0"],
            {
                "dilations": [1, 1], "group": groups, "kernel_shape": [k, k],
                "pads": [pad, pad, pad, pad], "strides": [stride, stride],
            },
        )
        if act:
            y = self._add(
                "Relu", f"{base}/Relu", [y], [f"{base}/Relu_output_0"]
            )
        return y

    def _shuffle(self, x: str, prefix: str, c: int, hw: int) -> str:
        """torchvision channel_shuffle: view (1, 2, c/2, h, w) ->
        transpose(1, 2) -> flatten back."""
        base = "/" + prefix
        s1 = self._const(
            f"{base}/shuffle_shape_0",
            np.asarray([1, 2, c // 2, hw, hw], np.int64),
        )
        y = self._add(
            "Reshape", f"{base}/shuffle/Reshape", [x, s1],
            [f"{base}/shuffle/Reshape_output_0"],
        )
        y = self._add(
            "Transpose", f"{base}/shuffle/Transpose", [y],
            [f"{base}/shuffle/Transpose_output_0"],
            {"perm": [0, 2, 1, 3, 4]},
        )
        s2 = self._const(
            f"{base}/shuffle_shape_1",
            np.asarray([1, c, hw, hw], np.int64),
        )
        return self._add(
            "Reshape", f"{base}/shuffle/Reshape_1", [y, s2],
            [f"{base}/shuffle/Reshape_1_output_0"],
        )

    def _unit(self, x: str, prefix: str, stride: int, hw: int) -> str:
        def branch2(inp: str) -> str:
            y = self._conv(inp, f"{prefix}.branch2.0", 1)
            dw = self.sd[f"{prefix}.branch2.3.weight"].shape[0]
            y = self._conv(
                y, f"{prefix}.branch2.3", 3, stride=stride, act=False,
                groups=dw,
            )
            return self._conv(y, f"{prefix}.branch2.5", 1)

        base = "/" + prefix
        if stride == 1:
            c_half = self.sd[f"{prefix}.branch2.0.weight"].shape[1]
            a, bhalf = f"{base}/Split_output_0", f"{base}/Split_output_1"
            self._add(
                "Split", f"{base}/Split", [x], [a, bhalf],
                {"axis": 1, "split": [c_half, c_half]},
            )
            out_c = 2 * c_half
            out = self._add(
                "Concat", f"{base}/Concat", [a, branch2(bhalf)],
                [f"{base}/Concat_output_0"], {"axis": 1},
            )
        else:
            dw = self.sd[f"{prefix}.branch1.0.weight"].shape[0]
            b1 = self._conv(
                x, f"{prefix}.branch1.0", 3, stride=2, act=False, groups=dw
            )
            b1 = self._conv(b1, f"{prefix}.branch1.2", 1)
            out_c = (
                self.sd[f"{prefix}.branch1.2.weight"].shape[0]
                + self.sd[f"{prefix}.branch2.5.weight"].shape[0]
            )
            out = self._add(
                "Concat", f"{base}/Concat", [b1, branch2(x)],
                [f"{base}/Concat_output_0"], {"axis": 1},
            )
        return self._shuffle(out, prefix, out_c, hw)

    def build(self) -> None:
        x = self._conv("images", "conv1.0", 3, 2)
        x = self._add(
            "MaxPool", "/maxpool/MaxPool", [x], ["/maxpool/MaxPool_output_0"],
            {
                "ceil_mode": 0, "dilations": [1, 1], "kernel_shape": [3, 3],
                "pads": [1, 1, 1, 1], "strides": [2, 2],
            },
        )
        hw = self.input_size // 4
        for s, reps in zip((2, 3, 4), self.stage_repeats):
            hw //= 2
            x = self._unit(x, f"stage{s}.0", 2, hw)
            for i in range(1, reps):
                x = self._unit(x, f"stage{s}.{i}", 1, hw)
        x = self._conv(x, "conv5.0", 1)
        # torchvision forward ends x.mean([2, 3]) -> fc; the trace is
        # ReduceMean(axes=[2,3], keepdims=0) -> Gemm(transB=1)
        x = self._add(
            "ReduceMean", "/ReduceMean", [x], ["/ReduceMean_output_0"],
            {"axes": [2, 3], "keepdims": 0},
        )
        self._add(
            "Gemm", "/fc/Gemm",
            [
                x,
                self._const(
                    "fc.weight",
                    np.ascontiguousarray(self.sd["fc.weight"], np.float32),
                ),
                self._const(
                    "fc.bias",
                    np.ascontiguousarray(self.sd["fc.bias"], np.float32),
                ),
            ],
            ["output0"], {"alpha": 1.0, "beta": 1.0, "transB": 1},
        )


def build_classifier_onnx(
    arch: str,
    sd: Mapping[str, np.ndarray],
    num_classes: int,
    input_size: int = 64,
) -> bytes:
    """Fused classifier state dict -> ONNX model bytes,
    ``images`` (1,3,s,s) -> ``output0`` (1,nc) logits."""
    if arch != "shufflenetv2":
        raise ValueError(
            f"ONNX classifier emission covers 'shufflenetv2' (the deployed "
            f"choice); got {arch!r}"
        )
    em = _ShuffleNetV2OnnxEmitter(sd, num_classes, input_size)
    em.build()
    return onnx_model_bytes(
        em.nodes, em.inits,
        (1, 3, input_size, input_size), (1, num_classes),
    )


def export_classifier_onnx(
    arch: str,
    variables: Dict,
    num_classes: int,
    path: str,
    input_size: int = 64,
) -> bytes:
    """Classifier sibling of :func:`export_detector_onnx` — rebuilds the
    reference's torch->ONNX classifier export (convert-model-classify
    .ipynb cell 3, the step its NCNN/OpenVINO classifier artifacts are
    converted from).  ShuffleNetV2 (the deployed choice) is emitted."""
    from litepi_tpu_torch.weights.ncnn_export import shufflenetv2_fused_state_dict

    if arch != "shufflenetv2":
        raise ValueError(
            f"ONNX classifier emission covers 'shufflenetv2' (the deployed "
            f"choice); got {arch!r}"
        )
    sd = shufflenetv2_fused_state_dict(variables)
    data = build_classifier_onnx(arch, sd, num_classes, input_size)
    with open(path, "wb") as f:
        f.write(data)
    return data
