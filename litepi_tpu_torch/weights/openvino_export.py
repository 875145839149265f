"""OpenVINO IR (``.xml`` + ``.bin``) graph emission (numpy only).

The port's copy of the JAX package's ``weights/openvino_export.py``.  From
the Flax-named numpy trees of the port's importers and checkpoint it
writes the IR vocabulary the reference's exports use: Convolution +
anonymous-bias Add + Swish per fused conv, VariadicSplit C2f branches,
opset14 MaxPool SPPF, opset11 scales-mode Interpolate, the DFL
Reshape/Transpose/SoftMax/Convolution chain, and torch's ``chunk(2)``
traced as the prim::ListUnpack ShapeOf/Gather/Divide/Mod/Greater/Convert
subgraph.  IR carries explicit per-port shapes on every edge, so the
emitter runs full shape inference while building.

Families:

* yolo_plus v1/v2 and stock yolov8n (C2f family — :class:`_C2fIrEmitter`);
* yolov5nu (C3 body, k=6 stem, model.24 head — ``yolo5.xml``);
* yolov11n (C3k2 body, C2PSA attention traced as MatMul/SoftMax with
  GroupConvolution positional conv, depthwise-separable cls head at
  model.23 — ``yolo11.xml``);
* the ShuffleNetV2 classifier.

The ``.xml`` and ``.bin`` equal the JAX emitter's byte for byte on the same
tree, and the IR runs through
:func:`litepi_tpu_torch.weights.openvino_import.run_ir_graph` (torch) to
the port's model plus decode (tests/test_torch_export_onnx_openvino.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from litepi_tpu_torch.core.types import DetectorConfig

# numpy dtype -> (IR element_type, port precision)
_DTYPE_MAP = {
    np.dtype(np.float32): ("f32", "FP32"),
    np.dtype(np.float16): ("f16", "FP16"),
    np.dtype(np.int64): ("i64", "I64"),
    np.dtype(np.int32): ("i32", "I32"),
    np.dtype(np.bool_): ("boolean", "BOOL"),
}


@dataclasses.dataclass
class _Value:
    """A produced tensor: (layer id, output port id, shape, precision)."""

    layer: int
    port: int
    shape: Tuple[int, ...]
    precision: str


class _IrEmitter:
    """Shared IR assembly + shape inference for the Ultralytics export
    families.  ``sd`` is keyed by Ultralytics module path
    (``model.0.conv.weight`` …) — the exact layout the ingestion-side
    state-dict builders produce, so emission and ingestion are inverses
    by construction.  Layer naming follows the real exports' torch-trace
    conventions so structural tests can compare named inventories."""

    # the traced SiLU module is deduplicated by torch to one shared
    # object, so every Swish carries the LAST act module's path (e.g.
    # yolo_plus.xml: all 57 Swish layers are named model.22.cv3.2.1.act)
    SHARED_ACT = "model.22.cv3.2.1.act"

    def __init__(self, sd: Mapping[str, np.ndarray]):
        self.sd = sd
        # layer dicts: id,name,type,version,data,in_ports,out_ports
        self.layers: List[Dict] = []
        self.edges: List[Tuple[int, int, int, int]] = []
        self.blob = bytearray()
        self._blob_index: Dict[bytes, int] = {}
        self._anon = 0
        self._act_count = 0

    # ------------------------------------------------------------------ #
    # low-level graph assembly
    # ------------------------------------------------------------------ #

    def _layer(
        self,
        ltype: str,
        name: str,
        version: str,
        data: Optional[Dict[str, str]],
        ins: Sequence[_Value],
        outs: Sequence[Tuple[Tuple[int, ...], str]],
        out_names: Optional[Sequence[Optional[str]]] = None,
    ) -> List[_Value]:
        lid = len(self.layers)
        in_ports = []
        for tp, v in enumerate(ins):
            self.edges.append((v.layer, v.port, lid, tp))
            in_ports.append({"id": tp, "shape": v.shape, "precision": v.precision})
        out_ports = []
        values = []
        for i, (shape, prec) in enumerate(outs):
            pid = len(ins) + i
            pname = out_names[i] if out_names else None
            out_ports.append(
                {"id": pid, "shape": shape, "precision": prec, "names": pname}
            )
            values.append(_Value(lid, pid, tuple(shape), prec))
        self.layers.append(
            {
                "id": lid, "name": name, "type": ltype, "version": version,
                "data": data or {}, "in": in_ports, "out": out_ports,
            }
        )
        return values

    def _const(
        self, name: str, arr: np.ndarray, port_name: Optional[str] = None
    ) -> _Value:
        # np.ascontiguousarray would promote 0-d scalars to 1-d; the IR
        # distinguishes scalar consts (shape="") from 1-element vectors
        arr = np.asarray(arr, order="C")
        etype, prec = _DTYPE_MAP[arr.dtype]
        raw = arr.tobytes()
        # identical payloads share one blob region (the real export stores
        # its repeated scalar axis consts at one offset — layers 17/377)
        off = self._blob_index.get(raw)
        if off is None:
            off = len(self.blob)
            self.blob += raw
            self._blob_index[raw] = off
        data = {
            "element_type": etype,
            "shape": ", ".join(str(d) for d in arr.shape),
            "offset": str(off),
            "size": str(len(raw)),
        }
        return self._layer(
            "Const", name, "opset1", data, [], [(arr.shape, prec)],
            out_names=[port_name],
        )[0]

    def _anon_const(self, arr: np.ndarray) -> _Value:
        self._anon += 1
        return self._const(f"Constant_{self._anon}", arr)

    def _next_tensor_id(self) -> int:
        # the real export names split-axis consts with bare trace-tensor
        # numbers ('109', '727'); a fresh counter keeps ours unique
        self._anon += 1
        return 100 + self._anon

    # ------------------------------------------------------------------ #
    # model blocks
    # ------------------------------------------------------------------ #

    def _swish(self, x: _Value) -> _Value:
        sfx = "" if self._act_count == 0 else f"_{self._act_count}"
        self._act_count += 1
        return self._layer(
            "Swish",
            f"__module.{self.SHARED_ACT}/aten::silu_/Swish{sfx}",
            "opset4", None, [x], [(x.shape, "FP32")],
        )[0]

    def _relu(self, x: _Value, path: str) -> _Value:
        # torchvision ReLUs are separate modules (unlike the shared traced
        # SiLU); no classifier IR survives upstream, so they are named
        # after the conv they follow
        return self._layer(
            "ReLU", f"__module.{path}/aten::relu_/Relu", "opset1", None,
            [x], [(x.shape, "FP32")],
        )[0]

    def _conv(
        self, x: _Value, path: str, k: int, stride: int = 1,
        act: bool = True, pad: Optional[int] = None,
        act_op: str = "Swish",
    ) -> _Value:
        stem = path if f"{path}.weight" in self.sd else f"{path}.conv"
        w = np.ascontiguousarray(self.sd[f"{stem}.weight"], np.float32)
        out_c = w.shape[0]
        if pad is None:
            pad = k // 2
        h = (x.shape[2] + 2 * pad - k) // stride + 1
        ww = (x.shape[3] + 2 * pad - k) // stride + 1
        wc = self._const(f"self.{stem}.weight", w, port_name=f"self.{stem}.weight")
        mod = f"__module.{stem}/aten::_convolution"
        y = self._layer(
            "Convolution", f"{mod}/Convolution", "opset1",
            {
                "strides": f"{stride}, {stride}",
                "dilations": "1, 1",
                "pads_begin": f"{pad}, {pad}",
                "pads_end": f"{pad}, {pad}",
                "auto_pad": "explicit",
            },
            [x, wc], [((1, out_c, h, ww), "FP32")],
        )[0]
        bias = self.sd.get(f"{stem}.bias")
        if bias is not None:
            bc = self._const(
                f"{mod}/Reshape",
                np.ascontiguousarray(bias, np.float32).reshape(1, -1, 1, 1),
            )
            y = self._layer(
                "Add", f"{mod}/Add", "opset1", {"auto_broadcast": "numpy"},
                [y, bc], [(y.shape, "FP32")],
            )[0]
        if not act:
            return y
        return self._relu(y, stem) if act_op == "ReLU" else self._swish(y)

    def _dwconv(
        self, x: _Value, path: str, k: int, act: bool = True,
        stride: int = 1, act_op: str = "Swish",
    ) -> _Value:
        """Depthwise conv traced as GroupConvolution with the 5-D
        (g, out/g=1, in/g=1, k, k) grouped weight — an anonymous Const
        named ``…/aten::_convolution/Reshape`` because torch stores
        (C, 1, k, k) and the converter reshapes it (yolo11.xml:221-224)."""
        stem = path if f"{path}.weight" in self.sd else f"{path}.conv"
        w = np.ascontiguousarray(self.sd[f"{stem}.weight"], np.float32)
        c = w.shape[0]
        pad = k // 2
        h = (x.shape[2] + 2 * pad - k) // stride + 1
        ww = (x.shape[3] + 2 * pad - k) // stride + 1
        mod = f"__module.{stem}/aten::_convolution"
        wc = self._const(f"{mod}/Reshape", w.reshape(c, 1, 1, k, k))
        y = self._layer(
            "GroupConvolution", f"{mod}/GroupConvolution", "opset1",
            {
                "strides": f"{stride}, {stride}",
                "pads_begin": f"{pad}, {pad}",
                "pads_end": f"{pad}, {pad}",
                "dilations": "1, 1",
                "auto_pad": "explicit",
            },
            [x, wc], [((1, c, h, ww), "FP32")],
        )[0]
        bias = self.sd.get(f"{stem}.bias")
        if bias is not None:
            bc = self._const(
                f"{mod}/Reshape_1",
                np.ascontiguousarray(bias, np.float32).reshape(1, -1, 1, 1),
            )
            y = self._layer(
                "Add", f"{mod}/Add", "opset1", {"auto_broadcast": "numpy"},
                [y, bc], [(y.shape, "FP32")],
            )[0]
        if not act:
            return y
        return self._relu(y, stem) if act_op == "ReLU" else self._swish(y)

    def _maxpool(self, x: _Value, name: str) -> _Value:
        return self._layer(
            "MaxPool", name, "opset14",
            {
                "strides": "1, 1", "dilations": "1, 1",
                "pads_begin": "2, 2", "pads_end": "2, 2",
                "kernel": "5, 5", "rounding_type": "floor",
                "auto_pad": "explicit", "index_element_type": "i64",
                "axis": "2",
            },
            [x], [(x.shape, "FP32"), (x.shape, "I64")],
        )[0]

    def _sppf(self, x: _Value, prefix: str = "model.9") -> _Value:
        y = self._conv(x, f"{prefix}.cv1", 1)
        p1 = self._maxpool(y, f"__module.{prefix}.m/aten::max_pool2d/MaxPool")
        p2 = self._maxpool(p1, f"__module.{prefix}.m/aten::max_pool2d/MaxPool_1")
        p3 = self._maxpool(p2, f"__module.{prefix}.m/aten::max_pool2d/MaxPool_2")
        cat = self._layer(
            "Concat", f"__module.{prefix}/aten::cat/Concat", "opset1",
            {"axis": "1"}, [y, p1, p2, p3],
            [((1, 4 * y.shape[1], y.shape[2], y.shape[3]), "FP32")],
        )[0]
        return self._conv(cat, f"{prefix}.cv2", 1)

    def _upsample(self, x: _Value, idx: int) -> _Value:
        mod = f"__module.model.{idx}/aten::upsample_nearest2d"
        scales = self._const(f"{mod}/Multiply", np.asarray([2.0, 2.0], np.float32))
        axes = self._anon_const(np.asarray([2, 3], np.int32))
        out = (1, x.shape[1], x.shape[2] * 2, x.shape[3] * 2)
        return self._layer(
            "Interpolate", f"{mod}/Interpolate", "opset11",
            {
                "mode": "nearest", "shape_calculation_mode": "scales",
                "coordinate_transformation_mode": "asymmetric",
                "nearest_mode": "floor", "antialias": "false",
                "pads_begin": "0, 0, 0, 0", "pads_end": "0, 0, 0, 0",
                "cube_coeff": "-0.75",
            },
            [x, scales, axes], [(out, "FP32")],
        )[0]

    def _concat(self, name: str, parts: Sequence[_Value], axis: int = 1) -> _Value:
        cat_c = sum(p.shape[axis] for p in parts)
        shape = list(parts[0].shape)
        shape[axis] = cat_c
        return self._layer(
            "Concat", name, "opset1", {"axis": str(axis)}, parts,
            [(tuple(shape), "FP32")],
        )[0]

    def _c2f(
        self, x: _Value, prefix: str, n: int, residual: bool
    ) -> _Value:
        h = self.sd[f"{prefix}.cv1.conv.weight"].shape[0] // 2
        y = self._conv(x, f"{prefix}.cv1", 1)
        axis = self._const(str(self._next_tensor_id()), np.int64(1))
        sizes = self._anon_const(np.asarray([h, h], np.int64))
        half_shape = (1, h, y.shape[2], y.shape[3])
        halves = self._layer(
            "VariadicSplit",
            f"__module.{prefix}/aten::split_with_sizes/VariadicSplit",
            "opset1", None, [y, axis, sizes],
            [(half_shape, "FP32"), (half_shape, "FP32")],
        )
        parts = list(halves)
        cur = halves[1]
        for j in range(n):
            t = self._conv(cur, f"{prefix}.m.{j}.cv1", 3)
            t = self._conv(t, f"{prefix}.m.{j}.cv2", 3)
            if residual:
                t = self._layer(
                    "Add", f"__module.{prefix}.m.{j}/aten::add/Add",
                    "opset1", {"auto_broadcast": "numpy"},
                    [cur, t], [(t.shape, "FP32")],
                )[0]
            parts.append(t)
            cur = t
        cat = self._concat(f"__module.{prefix}/aten::cat/Concat", parts)
        return self._conv(cat, f"{prefix}.cv2", 1)

    def _c3(
        self, x: _Value, prefix: str, n: int, residual: bool, k1: int = 1
    ) -> _Value:
        """C3 (v5: 1x1+3x3 bottlenecks) / C3k (v11: 3x3+3x3, ``k1=3``):
        parallel cv1/cv2 1x1s on the block input, concat, cv3
        (yolo5.xml layers 13-38)."""
        cur = self._conv(x, f"{prefix}.cv1", 1)
        for j in range(n):
            t = self._conv(cur, f"{prefix}.m.{j}.cv1", k1)
            t = self._conv(t, f"{prefix}.m.{j}.cv2", 3)
            if residual:
                t = self._layer(
                    "Add", f"__module.{prefix}.m.{j}/aten::add/Add",
                    "opset1", {"auto_broadcast": "numpy"},
                    [cur, t], [(t.shape, "FP32")],
                )[0]
            cur = t
        c2 = self._conv(x, f"{prefix}.cv2", 1)
        cat = self._concat(f"__module.{prefix}/aten::cat/Concat", [cur, c2])
        return self._conv(cat, f"{prefix}.cv3", 1)

    # ------------------------------------------------------------------ #
    # detection head + in-graph decode (shared across all families)
    # ------------------------------------------------------------------ #

    def _reg_branch(self, lvl: _Value, head: str, i: int) -> _Value:
        r = self._conv(lvl, f"{head}.cv2.{i}.0", 3)
        r = self._conv(r, f"{head}.cv2.{i}.1", 3)
        return self._conv(r, f"{head}.cv2.{i}.2", 1, act=False)

    def _cls_branch(self, lvl: _Value, head: str, i: int) -> _Value:
        """Plain 3x3+3x3+1x1 class branch (yolo_plus/v8/v5u); v11
        overrides with its depthwise-separable form."""
        cl = self._conv(lvl, f"{head}.cv3.{i}.0", 3)
        cl = self._conv(cl, f"{head}.cv3.{i}.1", 3)
        return self._conv(cl, f"{head}.cv3.{i}.2", 1, act=False)

    def _head_decode(
        self,
        levels: Sequence[_Value],
        head: str,
        reg_max: int,
        nc: int,
        input_size: int,
        strides: Sequence[int] = (8, 16, 32),
    ) -> None:
        from litepi_tpu_torch.ops.anchors import make_anchors

        no = 4 * reg_max + nc
        A = sum((input_size // s) ** 2 for s in strides)
        anchor_points, strides_arr = make_anchors(input_size, strides)
        anchors_c = self._const(
            f"__module.{head}/aten::unsqueeze/Unsqueeze",
            np.ascontiguousarray(anchor_points.T.astype(np.float32))[None],
            port_name="anchor_points",
        )
        h = f"__module.{head}"

        flats = []
        for i, lvl in enumerate(levels):
            r = self._reg_branch(lvl, head, i)
            cl = self._cls_branch(lvl, head, i)
            sfx = "" if i == 0 else f"_{i}"
            cat = self._concat(f"{h}/aten::cat/Concat{sfx}", [r, cl])
            shape_c = self._anon_const(np.asarray([1, no, -1], np.int64))
            flats.append(
                self._layer(
                    "Reshape", f"{h}/aten::view/Reshape{sfx}", "opset1",
                    {"special_zero": "false"}, [cat, shape_c],
                    [((1, no, cat.shape[2] * cat.shape[3]), "FP32")],
                )[0]
            )
        full = self._layer(
            "Concat", f"{h}/aten::cat/Concat_3", "opset1", {"axis": "2"},
            flats, [((1, no, A), "FP32")],
        )[0]
        axis_c = self._const(str(self._next_tensor_id()), np.int64(1))
        sizes_c = self._anon_const(np.asarray([4 * reg_max, nc], np.int64))
        box, cls = self._layer(
            "VariadicSplit", f"{h}/aten::split_with_sizes/VariadicSplit",
            "opset1", None, [full, axis_c, sizes_c],
            [((1, 4 * reg_max, A), "FP32"), ((1, nc, A), "FP32")],
        )

        # DFL: (1,4r,A) -> (1,4,r,A) -> transpose (1,r,4,A) -> softmax over
        # bins -> expectation conv -> (1,4,A)  (yolo_plus.xml:380-388)
        dfl = f"__module.{head}.dfl"
        shape_c = self._anon_const(np.asarray([1, 4, reg_max, A], np.int64))
        t = self._layer(
            "Reshape", f"{dfl}/aten::view/Reshape", "opset1",
            {"special_zero": "false"}, [box, shape_c],
            [((1, 4, reg_max, A), "FP32")],
        )[0]
        perm_c = self._const(
            f"{dfl}/aten::transpose/Constant",
            np.asarray([0, 2, 1, 3], np.int32),
        )
        t = self._layer(
            "Transpose", f"{dfl}/aten::transpose/Transpose", "opset1",
            None, [t, perm_c], [((1, reg_max, 4, A), "FP32")],
        )[0]
        t = self._layer(
            "SoftMax", f"{dfl}/aten::softmax/Softmax", "opset8",
            {"axis": "1"}, [t], [(t.shape, "FP32")],
        )[0]
        dfl_w = self._const(
            f"self.{head}.dfl.conv.weight",
            np.arange(reg_max, dtype=np.float32).reshape(1, reg_max, 1, 1),
            port_name=f"self.{head}.dfl.conv.weight",
        )
        t = self._layer(
            "Convolution", f"{dfl}.conv/aten::_convolution/Convolution",
            "opset1",
            {
                "strides": "1, 1", "dilations": "1, 1",
                "pads_begin": "0, 0", "pads_end": "0, 0",
                "auto_pad": "explicit",
            },
            [t, dfl_w], [((1, 1, 4, A), "FP32")],
        )[0]
        shape_c = self._anon_const(np.asarray([1, 4, A], np.int64))
        dist = self._layer(
            "Reshape", f"{dfl}/aten::view/Reshape_1", "opset1",
            {"special_zero": "false"}, [t, shape_c],
            [((1, 4, A), "FP32")],
        )[0]

        # torch chunk(2, dim=1) traced as a dynamic split-size subgraph
        # (yolo_plus.xml layers 389-400): sizes = [n//2 + (n%2>0), -1]
        lu = f"{h}/prim::ListUnpack"
        shape_of = self._layer(
            "ShapeOf", f"{lu}/ShapeOf", "opset3", {"output_type": "i32"},
            [dist], [((3,), "I32")],
        )[0]
        zero_c = self._anon_const(np.asarray([0], np.int32))
        gathered = self._layer(
            "Gather", f"{lu}/Gather", "opset8", {"batch_dims": "0"},
            [shape_of, axis_c, zero_c], [((), "I32")],
        )[0]
        two_c = self._const(f"{lu}/Convert", np.int32(2))
        div = self._layer(
            "Divide", f"{lu}/Divide", "opset1",
            {"auto_broadcast": "numpy", "m_pythondiv": "true"},
            [gathered, two_c], [((), "I32")],
        )[0]
        mod = self._layer(
            "Mod", f"{lu}/Mod", "opset1", {"auto_broadcast": "numpy"},
            [gathered, two_c], [((), "I32")],
        )[0]
        gt = self._layer(
            "Greater", f"{lu}/Greater", "opset1", {"auto_broadcast": "numpy"},
            [mod, zero_c], [((1,), "BOOL")],
        )[0]
        conv_i = self._layer(
            "Convert", f"{lu}/Convert_0", "opset1",
            {"destination_type": "i32"}, [gt], [((1,), "I32")],
        )[0]
        first = self._layer(
            "Add", f"{lu}/Add", "opset1", {"auto_broadcast": "numpy"},
            [div, conv_i], [((1,), "I32")],
        )[0]
        neg1_c = self._anon_const(np.asarray([-1], np.int32))
        sizes_dyn = self._layer(
            "Concat", f"{lu}/Concat", "opset1", {"axis": "0"},
            [first, neg1_c], [((2,), "I32")],
        )[0]
        lt, rb = self._layer(
            "VariadicSplit", f"{lu}/VariadicSplit", "opset1", None,
            [dist, axis_c, sizes_dyn],
            [((1, 2, A), "FP32"), ((1, 2, A), "FP32")],
        )

        x1y1 = self._layer(
            "Subtract", f"{h}/aten::sub/Subtract", "opset1",
            {"auto_broadcast": "numpy"}, [anchors_c, lt],
            [((1, 2, A), "FP32")],
        )[0]
        x2y2 = self._layer(
            "Add", f"{h}/aten::add/Add", "opset1",
            {"auto_broadcast": "numpy"}, [anchors_c, rb],
            [((1, 2, A), "FP32")],
        )[0]
        csum = self._layer(
            "Add", f"{h}/aten::add/Add_1", "opset1",
            {"auto_broadcast": "numpy"}, [x1y1, x2y2],
            [((1, 2, A), "FP32")],
        )[0]
        half_c = self._anon_const(np.asarray([2.0], np.float32).reshape(1, 1, 1))
        cxy = self._layer(
            "Divide", f"{h}/aten::div/Divide", "opset1",
            {"auto_broadcast": "numpy", "m_pythondiv": "true"},
            [csum, half_c], [((1, 2, A), "FP32")],
        )[0]
        wh = self._layer(
            "Subtract", f"{h}/aten::sub/Subtract_1", "opset1",
            {"auto_broadcast": "numpy"}, [x2y2, x1y1],
            [((1, 2, A), "FP32")],
        )[0]
        xywh = self._layer(
            "Concat", f"{h}/aten::cat/Concat_4", "opset1", {"axis": "1"},
            [cxy, wh], [((1, 4, A), "FP32")],
        )[0]
        strides_c = self._anon_const(
            np.ascontiguousarray(
                strides_arr.astype(np.float32).reshape(1, 1, -1)
            )
        )
        dbox = self._layer(
            "Multiply", f"{h}/aten::mul/Multiply", "opset1",
            {"auto_broadcast": "numpy"}, [xywh, strides_c],
            [((1, 4, A), "FP32")],
        )[0]
        sig = self._layer(
            "Sigmoid", f"{h}/aten::sigmoid/Sigmoid", "opset1", None,
            [cls], [((1, nc, A), "FP32")],
        )[0]
        out = self._layer(
            "Concat", f"{h}/aten::cat/Concat_5", "opset1", {"axis": "1"},
            [dbox, sig], [((1, 4 + nc, A), "FP32")],
        )[0]
        self._layer("Result", "Result_0", "opset1", None, [out], [])

    def _parameter(self, input_size: int) -> _Value:
        return self._layer(
            "Parameter", "x", "opset1",
            {"shape": f"1,3,{input_size},{input_size}", "element_type": "f32"},
            [], [((1, 3, input_size, input_size), "FP32")], out_names=["x"],
        )[0]


class _C2fIrEmitter(_IrEmitter):
    """yolo_plus v1/v2 and stock yolov8n (C2f backbone+neck, model.22
    DFL head) — the family of the surviving ``yolo_plus.xml``."""

    SHARED_ACT = "model.22.cv3.2.1.act"

    def __init__(self, cfg: DetectorConfig, sd: Mapping[str, np.ndarray]):
        super().__init__(sd)
        self.cfg = cfg

    def build(self) -> None:
        cfg = self.cfg
        d = cfg.depths
        n_neck = d[0]
        sc = cfg.neck_shortcut
        s = cfg.input_size

        x = self._parameter(s)
        x = self._conv(x, "model.0", 3, 2)
        x = self._conv(x, "model.1", 3, 2)
        x = self._c2f(x, "model.2", d[0], True)
        x = self._conv(x, "model.3", 3, 2)
        p3 = self._c2f(x, "model.4", d[1], True)
        x = self._conv(p3, "model.5", 3, 2)
        p4 = self._c2f(x, "model.6", d[2], True)
        x = self._conv(p4, "model.7", 3, 2)
        x = self._c2f(x, "model.8", d[3], True)
        p5 = self._sppf(x)

        up = self._upsample(p5, 10)
        t4 = self._concat("__module.model.11/aten::cat/Concat", [up, p4])
        t4 = self._c2f(t4, "model.12", n_neck, sc)
        up = self._upsample(t4, 13)
        t3 = self._concat("__module.model.14/aten::cat/Concat", [up, p3])
        n3 = self._c2f(t3, "model.15", n_neck, sc)
        dconv = self._conv(n3, "model.16", 3, 2)
        b4 = self._concat("__module.model.17/aten::cat/Concat", [dconv, t4])
        n4 = self._c2f(b4, "model.18", n_neck, sc)
        dconv = self._conv(n4, "model.19", 3, 2)
        b5 = self._concat("__module.model.20/aten::cat/Concat", [dconv, p5])
        n5 = self._c2f(b5, "model.21", n_neck, sc)
        self._head_decode(
            (n3, n4, n5), "model.22", cfg.reg_max, cfg.num_classes,
            cfg.input_size, cfg.strides,
        )


class _V5uIrEmitter(_IrEmitter):
    """yolov5nu — the deployed 'yolo5' baseline (v5 C3 body, k=6 p=2
    stem, v8 DFL head at model.24 — yolo5.xml)."""

    SHARED_ACT = "model.24.cv3.2.1.act"
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

    def build(self) -> None:
        d = self.DEPTHS
        x = self._parameter(self.input_size)
        # Ultralytics' v5 stem is Conv(3, c1, k=6, s=2, p=2) — explicit
        # pad 2, not the k//2=3 autopad (yolo5.xml layer 3 pads_begin=2,2)
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
        up = self._upsample(y10, 11)
        t4 = self._concat("__module.model.12/aten::cat/Concat", [up, p4])
        t4 = self._c3(t4, "model.13", 1, False)
        y14 = self._conv(t4, "model.14", 1)
        up = self._upsample(y14, 15)
        t3 = self._concat("__module.model.16/aten::cat/Concat", [up, p3])
        n3 = self._c3(t3, "model.17", 1, False)
        dconv = self._conv(n3, "model.18", 3, 2)
        b4 = self._concat("__module.model.19/aten::cat/Concat", [dconv, y14])
        n4 = self._c3(b4, "model.20", 1, False)
        dconv = self._conv(n4, "model.21", 3, 2)
        b5 = self._concat("__module.model.22/aten::cat/Concat", [dconv, y10])
        n5 = self._c3(b5, "model.23", 1, False)
        self._head_decode(
            (n3, n4, n5), "model.24", 16, self.num_classes, self.input_size
        )


class _V11IrEmitter(_IrEmitter):
    """yolov11n (C3k2 body, C2PSA attention, depthwise-separable cls head
    at model.23 — yolo11.xml)."""

    SHARED_ACT = "model.23.cv3.2.1.1.act"
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

    def _c3k2(self, x: _Value, prefix: str, n: int, c3k: bool) -> _Value:
        # C2f-shaped: cv1 -> split halves -> m chain -> concat -> cv2;
        # m is a full C3k block (3x3+3x3 bottlenecks) or one half-expansion
        # residual bottleneck (hidden derived from the cv1 weight)
        h = self.sd[f"{prefix}.cv1.conv.weight"].shape[0] // 2
        y = self._conv(x, f"{prefix}.cv1", 1)
        axis = self._const(str(self._next_tensor_id()), np.int64(1))
        sizes = self._anon_const(np.asarray([h, h], np.int64))
        half_shape = (1, h, y.shape[2], y.shape[3])
        halves = self._layer(
            "VariadicSplit",
            f"__module.{prefix}/aten::split_with_sizes/VariadicSplit",
            "opset1", None, [y, axis, sizes],
            [(half_shape, "FP32"), (half_shape, "FP32")],
        )
        parts = list(halves)
        cur = halves[1]
        for j in range(n):
            if c3k:
                t = self._c3(cur, f"{prefix}.m.{j}", 2, True, k1=3)
            else:
                t = self._conv(cur, f"{prefix}.m.{j}.cv1", 3)
                t = self._conv(t, f"{prefix}.m.{j}.cv2", 3)
                t = self._layer(
                    "Add", f"__module.{prefix}.m.{j}/aten::add/Add",
                    "opset1", {"auto_broadcast": "numpy"},
                    [cur, t], [(t.shape, "FP32")],
                )[0]
            parts.append(t)
            cur = t
        cat = self._concat(f"__module.{prefix}/aten::cat/Concat", parts)
        return self._conv(cat, f"{prefix}.cv2", 1)

    def _attention(self, x: _Value, prefix: str) -> _Value:
        """Ultralytics Attention as torch traces it (yolo11.xml layers
        204-229): qkv conv -> view (1, nh, 2*kd+hd, N) -> q/k/v split ->
        qT@k (MatMul transpose_a) -> scale -> softmax(-1) -> v@attnT
        (MatMul transpose_b) -> spatial reshape + depthwise positional
        GroupConvolution -> proj."""
        dim = self.DIM
        nh = max(dim // 64, 1)
        hd = dim // nh
        kd = hd // 2
        size = x.shape[2]
        N = size * size
        mod = f"__module.{prefix}"

        qkv = self._conv(x, f"{prefix}.qkv", 1, act=False)
        shape_c = self._anon_const(
            np.asarray([1, nh, 2 * kd + hd, N], np.int64)
        )
        t = self._layer(
            "Reshape", f"{mod}/aten::view/Reshape", "opset1",
            {"special_zero": "false"}, [qkv, shape_c],
            [((1, nh, 2 * kd + hd, N), "FP32")],
        )[0]
        axis_c = self._const(str(self._next_tensor_id()), np.int64(2))
        sizes_c = self._anon_const(np.asarray([kd, kd, hd], np.int64))
        q, k, v = self._layer(
            "VariadicSplit",
            f"{mod}/aten::split_with_sizes/VariadicSplit",
            "opset1", None, [t, axis_c, sizes_c],
            [
                ((1, nh, kd, N), "FP32"),
                ((1, nh, kd, N), "FP32"),
                ((1, nh, hd, N), "FP32"),
            ],
        )
        scores = self._layer(
            "MatMul", f"{mod}/aten::matmul/MatMul", "opset1",
            {"transpose_a": "true", "transpose_b": "false"},
            [q, k], [((1, nh, N, N), "FP32")],
        )[0]
        scale_c = self._anon_const(
            np.asarray(kd ** -0.5, np.float32).reshape(1, 1, 1, 1)
        )
        scores = self._layer(
            "Multiply", f"{mod}/aten::mul/Multiply", "opset1",
            {"auto_broadcast": "numpy"}, [scores, scale_c],
            [((1, nh, N, N), "FP32")],
        )[0]
        attn = self._layer(
            "SoftMax", f"{mod}/aten::softmax/Softmax", "opset8",
            {"axis": "-1"}, [scores], [((1, nh, N, N), "FP32")],
        )[0]
        o = self._layer(
            "MatMul", f"{mod}/aten::matmul/MatMul_1", "opset1",
            {"transpose_a": "false", "transpose_b": "true"},
            [v, attn], [((1, nh, hd, N), "FP32")],
        )[0]
        spatial_c = self._anon_const(
            np.asarray([1, dim, size, size], np.int64)
        )
        o = self._layer(
            "Reshape", f"{mod}/aten::view/Reshape_1", "opset1",
            {"special_zero": "false"}, [o, spatial_c],
            [((1, dim, size, size), "FP32")],
        )[0]
        pe_in = self._layer(
            "Reshape", f"{mod}/aten::reshape/Reshape", "opset1",
            {"special_zero": "false"},
            [v, self._anon_const(np.asarray([1, dim, size, size], np.int64))],
            [((1, dim, size, size), "FP32")],
        )[0]
        pe = self._dwconv(pe_in, f"{prefix}.pe", 3, act=False)
        o = self._layer(
            "Add", f"{mod}/aten::add/Add", "opset1",
            {"auto_broadcast": "numpy"}, [o, pe],
            [((1, dim, size, size), "FP32")],
        )[0]
        return self._conv(o, f"{prefix}.proj", 1, act=False)

    def _c2psa(self, x: _Value, prefix: str) -> _Value:
        dim = self.DIM
        y = self._conv(x, f"{prefix}.cv1", 1)
        axis = self._const(str(self._next_tensor_id()), np.int64(1))
        sizes = self._anon_const(np.asarray([dim, dim], np.int64))
        half_shape = (1, dim, y.shape[2], y.shape[3])
        a, bhalf = self._layer(
            "VariadicSplit",
            f"__module.{prefix}/aten::split_with_sizes/VariadicSplit",
            "opset1", None, [y, axis, sizes],
            [(half_shape, "FP32"), (half_shape, "FP32")],
        )
        attn = self._attention(bhalf, f"{prefix}.m.0.attn")
        t = self._layer(
            "Add", f"__module.{prefix}.m.0/aten::add/Add", "opset1",
            {"auto_broadcast": "numpy"}, [bhalf, attn],
            [(half_shape, "FP32")],
        )[0]
        ffn = self._conv(t, f"{prefix}.m.0.ffn.0", 1)
        ffn = self._conv(ffn, f"{prefix}.m.0.ffn.1", 1, act=False)
        t = self._layer(
            "Add", f"__module.{prefix}.m.0/aten::add/Add_1", "opset1",
            {"auto_broadcast": "numpy"}, [t, ffn],
            [(half_shape, "FP32")],
        )[0]
        cat = self._concat(f"__module.{prefix}/aten::cat/Concat", [a, t])
        return self._conv(cat, f"{prefix}.cv2", 1)

    def _cls_branch(self, lvl: _Value, head: str, i: int) -> _Value:
        cl = self._dwconv(lvl, f"{head}.cv3.{i}.0.0", 3)
        cl = self._conv(cl, f"{head}.cv3.{i}.0.1", 1)
        cl = self._dwconv(cl, f"{head}.cv3.{i}.1.0", 3)
        cl = self._conv(cl, f"{head}.cv3.{i}.1.1", 1)
        return self._conv(cl, f"{head}.cv3.{i}.2", 1, act=False)

    def build(self) -> None:
        x = self._parameter(self.input_size)
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

        up = self._upsample(p5, 11)
        t4 = self._concat("__module.model.12/aten::cat/Concat", [up, p4])
        t4 = self._c3k2(t4, "model.13", 1, False)
        up = self._upsample(t4, 14)
        t3 = self._concat("__module.model.15/aten::cat/Concat", [up, p3])
        n3 = self._c3k2(t3, "model.16", 1, False)
        dconv = self._conv(n3, "model.17", 3, 2)
        b4 = self._concat("__module.model.18/aten::cat/Concat", [dconv, t4])
        n4 = self._c3k2(b4, "model.19", 1, False)
        dconv = self._conv(n4, "model.20", 3, 2)
        b5 = self._concat("__module.model.21/aten::cat/Concat", [dconv, p5])
        n5 = self._c3k2(b5, "model.22", 1, True)
        self._head_decode(
            (n3, n4, n5), "model.23", 16, self.num_classes, self.input_size
        )


class _ShuffleNetV2IrEmitter(_IrEmitter):
    """ShuffleNetV2 x1.0 — the deployed classifier, which the reference
    also ships as OpenVINO IR (convert-model-classify.ipynb cell 17
    evaluates the IR form; no classifier artifact survives the blob
    strip, so the vocabulary is the fused eval-mode trace — Convolution/
    GroupConvolution + Add + ReLU, MaxPool k3 s2, VariadicSplit halves,
    the 5-D Reshape/Transpose/Reshape channel shuffle, ReduceMean spatial
    mean, MatMul(transpose_b) fc — and validation is interpreter forward
    parity + re-ingestion)."""

    def __init__(
        self,
        sd: Mapping[str, np.ndarray],
        num_classes: int,
        input_size: int = 64,
        stage_repeats=(4, 8, 4),
    ):
        super().__init__(sd)
        self.num_classes = num_classes
        self.input_size = input_size
        self.stage_repeats = stage_repeats

    def _shuffle(self, x: _Value, prefix: str) -> _Value:
        c, hw = x.shape[1], x.shape[2]
        mod = f"__module.{prefix}"
        s1 = self._anon_const(np.asarray([1, 2, c // 2, hw, hw], np.int64))
        y = self._layer(
            "Reshape", f"{mod}/aten::view/Reshape", "opset1",
            {"special_zero": "false"}, [x, s1],
            [((1, 2, c // 2, hw, hw), "FP32")],
        )[0]
        perm = self._const(
            f"{mod}/aten::transpose/Constant",
            np.asarray([0, 2, 1, 3, 4], np.int32),
        )
        y = self._layer(
            "Transpose", f"{mod}/aten::transpose/Transpose", "opset1",
            None, [y, perm], [((1, c // 2, 2, hw, hw), "FP32")],
        )[0]
        s2 = self._anon_const(np.asarray([1, c, hw, hw], np.int64))
        return self._layer(
            "Reshape", f"{mod}/aten::view/Reshape_1", "opset1",
            {"special_zero": "false"}, [y, s2],
            [((1, c, hw, hw), "FP32")],
        )[0]

    def _unit(self, x: _Value, prefix: str, stride: int) -> _Value:
        def branch2(inp: _Value) -> _Value:
            y = self._conv(inp, f"{prefix}.branch2.0", 1, act_op="ReLU")
            y = self._dwconv(
                y, f"{prefix}.branch2.3", 3, act=False, stride=stride
            )
            return self._conv(y, f"{prefix}.branch2.5", 1, act_op="ReLU")

        if stride == 1:
            c_half = self.sd[f"{prefix}.branch2.0.weight"].shape[1]
            axis = self._const(str(self._next_tensor_id()), np.int64(1))
            sizes = self._anon_const(np.asarray([c_half, c_half], np.int64))
            half_shape = (1, c_half, x.shape[2], x.shape[3])
            a, bhalf = self._layer(
                "VariadicSplit",
                f"__module.{prefix}/aten::chunk/VariadicSplit",
                "opset1", None, [x, axis, sizes],
                [(half_shape, "FP32"), (half_shape, "FP32")],
            )
            out = self._concat(
                f"__module.{prefix}/aten::cat/Concat", [a, branch2(bhalf)]
            )
        else:
            b1 = self._dwconv(x, f"{prefix}.branch1.0", 3, act=False, stride=2)
            b1 = self._conv(b1, f"{prefix}.branch1.2", 1, act_op="ReLU")
            out = self._concat(
                f"__module.{prefix}/aten::cat/Concat", [b1, branch2(x)]
            )
        return self._shuffle(out, prefix)

    def build(self) -> None:
        x = self._parameter(self.input_size)
        x = self._conv(x, "conv1.0", 3, 2, act_op="ReLU")
        hs = (x.shape[2] + 2 - 3) // 2 + 1
        x = self._layer(
            "MaxPool", "__module.maxpool/aten::max_pool2d/MaxPool",
            "opset14",
            {
                "strides": "2, 2", "dilations": "1, 1",
                "pads_begin": "1, 1", "pads_end": "1, 1",
                "kernel": "3, 3", "rounding_type": "floor",
                "auto_pad": "explicit", "index_element_type": "i64",
                "axis": "2",
            },
            [x], [((1, x.shape[1], hs, hs), "FP32"),
                  ((1, x.shape[1], hs, hs), "I64")],
        )[0]
        for s, reps in zip((2, 3, 4), self.stage_repeats):
            x = self._unit(x, f"stage{s}.0", 2)
            for i in range(1, reps):
                x = self._unit(x, f"stage{s}.{i}", 1)
        x = self._conv(x, "conv5.0", 1, act_op="ReLU")
        # torchvision forward ends x.mean([2, 3]) -> fc
        axes = self._anon_const(np.asarray([2, 3], np.int64))
        x = self._layer(
            "ReduceMean", "__module/aten::mean/ReduceMean", "opset1",
            {"keep_dims": "false"}, [x, axes],
            [((1, x.shape[1]), "FP32")],
        )[0]
        w = np.ascontiguousarray(self.sd["fc.weight"], np.float32)
        wc = self._const("self.fc.weight", w, port_name="self.fc.weight")
        y = self._layer(
            "MatMul", "__module.fc/aten::linear/MatMul", "opset1",
            {"transpose_a": "false", "transpose_b": "true"},
            [x, wc], [((1, self.num_classes), "FP32")],
        )[0]
        bc = self._const(
            "__module.fc/aten::linear/Add",
            np.ascontiguousarray(self.sd["fc.bias"], np.float32).reshape(
                1, -1
            ),
        )
        y = self._layer(
            "Add", "__module.fc/aten::linear/Add_1", "opset1",
            {"auto_broadcast": "numpy"}, [y, bc],
            [((1, self.num_classes), "FP32")],
        )[0]
        self._layer("Result", "Result_0", "opset1", None, [y], [])


# --------------------------------------------------------------------------- #
# serialization + public entry points
# --------------------------------------------------------------------------- #


def _port_xml(port: Dict, out: List[str]) -> None:
    names = port.get("names")
    attr = f' names="{names}"' if names else ""
    if port["shape"]:
        out.append(f'\t\t\t\t<port id="{port["id"]}" precision="{port["precision"]}"{attr}>')
        for d in port["shape"]:
            out.append(f"\t\t\t\t\t<dim>{d}</dim>")
        out.append("\t\t\t\t</port>")
    else:
        out.append(
            f'\t\t\t\t<port id="{port["id"]}" precision="{port["precision"]}"{attr} />'
        )


def ir_xml_bytes(
    layers: Sequence[Dict],
    edges: Sequence[Tuple[int, int, int, int]],
    name: str = "Model0",
) -> bytes:
    """Assemble the ``.xml`` text (net version 11, the real export's)."""
    from xml.sax.saxutils import quoteattr

    out: List[str] = ['<?xml version="1.0"?>', f'<net name="{name}" version="11">']
    out.append("\t<layers>")
    for l in layers:
        out.append(
            f'\t\t<layer id="{l["id"]}" name={quoteattr(l["name"])} '
            f'type="{l["type"]}" version="{l["version"]}">'
        )
        if l["data"]:
            attrs = " ".join(
                f'{k}={quoteattr(v)}' for k, v in l["data"].items()
            )
            out.append(f"\t\t\t<data {attrs} />")
        if l["in"]:
            out.append("\t\t\t<input>")
            for p in l["in"]:
                _port_xml(p, out)
            out.append("\t\t\t</input>")
        if l["out"]:
            out.append("\t\t\t<output>")
            for p in l["out"]:
                _port_xml(p, out)
            out.append("\t\t\t</output>")
        out.append("\t\t</layer>")
    out.append("\t</layers>")
    out.append("\t<edges>")
    for f, fp, t, tp in edges:
        out.append(
            f'\t\t<edge from-layer="{f}" from-port="{fp}" '
            f'to-layer="{t}" to-port="{tp}" />'
        )
    out.append("\t</edges>")
    out.append("\t<rt_info>")
    out.append("\t\t<conversion_parameters>")
    out.append('\t\t\t<framework value="litepi_tpu" />')
    out.append("\t\t</conversion_parameters>")
    out.append("\t</rt_info>")
    out.append("</net>")
    return ("\n".join(out) + "\n").encode("utf-8")


def build_detector_ir(
    cfg: DetectorConfig, sd: Mapping[str, np.ndarray]
) -> Tuple[bytes, bytes]:
    """Fused state dict + config -> (``.xml`` bytes, ``.bin`` bytes) for a
    yolo_plus/v8-family detector, in-graph decode, ``x`` -> (1, 4+nc, A)."""
    em = _C2fIrEmitter(cfg, sd)
    em.build()
    return ir_xml_bytes(em.layers, em.edges, name=cfg.name), bytes(em.blob)


def build_variant_ir(
    variant: str,
    sd: Mapping[str, np.ndarray],
    num_classes: int = 1,
    input_size: int = 640,
) -> Tuple[bytes, bytes]:
    """Baseline-variant fused state dict -> IR pair, layer-inventory
    verified against the shipped ``yolo5.xml``/``yolo11.xml``."""
    emitters = {"yolov5nu": _V5uIrEmitter, "yolov11n": _V11IrEmitter}
    if variant not in emitters:
        raise ValueError(
            f"unknown variant {variant!r}; choices: {sorted(emitters)}"
        )
    em = emitters[variant](sd, num_classes, input_size)
    em.build()
    return ir_xml_bytes(em.layers, em.edges, name=variant), bytes(em.blob)


def _write_ir_pair(
    xml_data: bytes, bin_data: bytes, xml_path: str, bin_path: Optional[str]
) -> None:
    if bin_path is None:
        bin_path = xml_path[: -len(".xml")] + ".bin" if xml_path.endswith(
            ".xml"
        ) else xml_path + ".bin"
    with open(xml_path, "wb") as f:
        f.write(xml_data)
    with open(bin_path, "wb") as f:
        f.write(bin_data)


def export_detector_openvino(
    variables: Dict, cfg: DetectorConfig, xml_path: str,
    bin_path: Optional[str] = None,
) -> Tuple[bytes, bytes]:
    """Write a deployable IR pair for a yolo_plus/v8-family detector —
    the reference's OpenVINO backend format (runner.py:183 compiles it).
    Accepts training- or deploy-form variables."""
    from litepi_tpu_torch.weights.ncnn_export import detector_fused_state_dict

    sd = detector_fused_state_dict(variables, cfg)
    xml_data, bin_data = build_detector_ir(cfg, sd)
    _write_ir_pair(xml_data, bin_data, xml_path, bin_path)
    return xml_data, bin_data


def export_detector_openvino_variant(
    variables: Dict,
    variant: str,
    xml_path: str,
    bin_path: Optional[str] = None,
    num_classes: int = 1,
    input_size: int = 640,
) -> Tuple[bytes, bytes]:
    """Baseline-variant sibling of :func:`export_detector_openvino` —
    emits the yolov5nu / yolov11n IRs (the deployed baselines' exact
    structures) from YoloV5(anchor_free=True) / YoloV11 variables."""
    from litepi_tpu_torch.weights.ncnn_export import (
        yolov5u_fused_state_dict,
        yolov11_fused_state_dict,
    )

    builders = {
        "yolov5nu": yolov5u_fused_state_dict,
        "yolov11n": yolov11_fused_state_dict,
    }
    if variant not in builders:
        raise ValueError(
            f"unknown variant {variant!r}; choices: {sorted(builders)}"
        )
    sd = builders[variant](variables)
    xml_data, bin_data = build_variant_ir(variant, sd, num_classes, input_size)
    _write_ir_pair(xml_data, bin_data, xml_path, bin_path)
    return xml_data, bin_data


def build_classifier_ir(
    arch: str,
    sd: Mapping[str, np.ndarray],
    num_classes: int,
    input_size: int = 64,
) -> Tuple[bytes, bytes]:
    """Fused classifier state dict -> IR pair, ``x`` (1,3,s,s) ->
    (1, nc) logits."""
    if arch != "shufflenetv2":
        raise ValueError(
            f"OpenVINO classifier emission covers 'shufflenetv2' (the "
            f"deployed choice); got {arch!r}"
        )
    em = _ShuffleNetV2IrEmitter(sd, num_classes, input_size)
    em.build()
    return ir_xml_bytes(em.layers, em.edges, name=arch), bytes(em.blob)


def export_classifier_openvino(
    arch: str,
    variables: Dict,
    num_classes: int,
    xml_path: str,
    bin_path: Optional[str] = None,
    input_size: int = 64,
) -> Tuple[bytes, bytes]:
    """Classifier sibling of :func:`export_detector_openvino` — rebuilds
    the reference's OpenVINO classifier export (convert-model-classify
    .ipynb cell 17 evaluates this form).  ShuffleNetV2 (the deployed
    choice) is emitted."""
    from litepi_tpu_torch.weights.ncnn_export import shufflenetv2_fused_state_dict

    if arch != "shufflenetv2":
        raise ValueError(
            f"OpenVINO classifier emission covers 'shufflenetv2' (the "
            f"deployed choice); got {arch!r}"
        )
    sd = shufflenetv2_fused_state_dict(variables)
    xml_data, bin_data = build_classifier_ir(arch, sd, num_classes, input_size)
    _write_ir_pair(xml_data, bin_data, xml_path, bin_path)
    return xml_data, bin_data
