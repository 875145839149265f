"""ONNX graph-initializer importer (numpy and ``struct`` only).

The port's copy of the JAX package's ``weights/onnx_import.py``.  It
returns numpy variable trees with the Flax names, as the JAX importer
does; its graph interpreter :func:`run_onnx_graph` (the emitters' oracle)
runs torch ops on a device.

No ``onnx`` package is needed: the initializers are read straight off the
protobuf wire format.  Only the pieces needed to recover weights are
decoded: ``ModelProto.graph`` (field 7) -> ``GraphProto.initializer``
(field 5, repeated ``TensorProto``) -> name / dims / data_type / raw or
typed data, plus the node list for the Identity aliases and the traced
classifier.

Fused exports are handled: Ultralytics fuses Conv+BN before export, so a
fused graph carries ``X.conv.weight`` + ``X.conv.bias`` and no ``X.bn.*``.
:func:`defuse_state_dict` rebuilds an identity BatchNorm around the fused
bias (scale 1, mean 0, var ``1 - eps`` so the BN divisor is exactly 1),
letting one converter (:func:`litepi_tpu_torch.weights.torch_import.
convert_detector_state_dict`) serve both fused and unfused artifacts.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, Iterator, List, Tuple, Union

import numpy as np
import torch

from litepi_tpu_torch.core.device import resolve_device
from litepi_tpu_torch.weights import graph_ops as gops

# flax ConvBN BatchNorm epsilon (models/layers.py) — the defused var must
# compensate it exactly: scale*(x-0)/sqrt((1-eps)+eps) + bias == x + bias
BN_EPS = 1e-3

# ONNX TensorProto.DataType -> numpy dtype (the ones that appear in exports)
_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
}


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, Union[int, bytes]]]:
    """Iterate (field_number, wire_type, value) over a protobuf message.
    LEN fields yield bytes; varints yield ints; fixed32/64 yield bytes."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 0x7
        if wire == 0:  # varint
            val, i = _read_varint(buf, i)
        elif wire == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            val = buf[i : i + ln]
            i += ln
        elif wire == 5:  # fixed32
            val = buf[i : i + 4]
            i += 4
        elif wire == 1:  # fixed64
            val = buf[i : i + 8]
            i += 8
        else:  # groups (3/4) never appear in onnx
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    """Decode one TensorProto: (name, array)."""
    dims = []
    dtype_code = 1
    name = ""
    raw = None
    float_data = []
    int_data = []
    for field, wire, val in _fields(buf):
        if field == 1:  # dims (packed or unpacked int64)
            if wire == 0:
                dims.append(val)
            else:
                i = 0
                while i < len(val):
                    d, i = _read_varint(val, i)
                    dims.append(d)
        elif field == 2:
            dtype_code = val
        elif field == 4:  # float_data, packed 4-byte floats
            float_data.append(val)
        elif field in (5, 7):  # int32_data / int64_data, packed varints
            i = 0
            while i < len(val):
                d, i = _read_varint(val, i)
                int_data.append(d)
        elif field == 8:
            name = val.decode("utf-8")
        elif field == 9:
            raw = val
    np_dtype = _DTYPES.get(dtype_code)
    if np_dtype is None:
        raise ValueError(f"initializer {name!r}: unsupported dtype {dtype_code}")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif float_data:
        arr = np.frombuffer(b"".join(float_data), dtype=np.float32)
    elif int_data:
        # packed varints are two's-complement: wrap >= 2^63 back to negative
        # (Slice ends of INT64_MAX-1 appear as-is; negative axes wrap)
        signed = [v - (1 << 64) if v >= (1 << 63) else v for v in int_data]
        arr = np.asarray(signed, dtype=np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    return name, arr.reshape(dims) if dims else arr


def read_onnx_initializers(
    src: Union[str, bytes],
) -> Dict[str, np.ndarray]:
    """All graph initializers of an ONNX file as ``{name: array}`` (float16
    upcast to float32 — Ultralytics exports are often fp16)."""
    data = src if isinstance(src, bytes) else open(src, "rb").read()
    out: Dict[str, np.ndarray] = {}
    for field, _, graph in _fields(data):
        if field != 7:  # ModelProto.graph
            continue
        for gfield, _, tensor in _fields(graph):
            if gfield != 5:  # GraphProto.initializer
                continue
            name, arr = _parse_tensor(tensor)
            if arr.dtype == np.float16:
                arr = arr.astype(np.float32)
            out[name] = arr
    return out


# --------------------------------------------------------------------------- #
# full graph reading
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class OnnxNode:
    op: str
    name: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any]


def _parse_attr(buf: bytes) -> Tuple[str, Any]:
    """One AttributeProto -> (name, python value).  Covers the attribute
    kinds real exports use: INT / FLOAT / STRING / INTS / TENSOR (the
    TENSOR kind carries ``Constant`` node payloads in torch.onnx output)."""
    name = ""
    value: Any = None
    ints: List[int] = []
    for field, wire, val in _fields(buf):
        if field == 1 and isinstance(val, bytes):
            name = val.decode()
        elif field == 2 and isinstance(val, bytes):  # f (fixed32)
            value = struct.unpack("<f", val)[0]
        elif field == 3 and isinstance(val, int):  # i
            value = val
        elif field == 4 and isinstance(val, bytes):  # s
            value = val.decode()
        elif field == 5 and isinstance(val, bytes):  # t (TensorProto)
            _, value = _parse_tensor(val)
        elif field == 8:  # ints (packed or repeated)
            if wire == 0:
                ints.append(val)
            elif isinstance(val, bytes):
                i = 0
                while i < len(val):
                    d, i = _read_varint(val, i)
                    ints.append(d)
    return name, (ints if ints else value)


def read_onnx_graph(src: Union[str, bytes]):
    """Full graph: ``(nodes, initializers, input_names, output_names)``.

    The node list complements :func:`read_onnx_initializers` for
    structural verification and interpretation of the reference's real
    exports (src/vntsr/convert/model/yolo_plus/yolo_plus.onnx)."""
    data = src if isinstance(src, bytes) else open(src, "rb").read()
    nodes: List[OnnxNode] = []
    inits: Dict[str, np.ndarray] = {}
    graph_inputs: List[str] = []
    graph_outputs: List[str] = []

    def _io_name(buf: bytes) -> str:
        for field, _, val in _fields(buf):
            if field == 1 and isinstance(val, bytes):
                return val.decode()
        return ""

    for field, _, graph in _fields(data):
        if field != 7 or not isinstance(graph, bytes):
            continue
        for gfield, _, val in _fields(graph):
            if gfield == 1 and isinstance(val, bytes):  # node
                ins, outs, name, op = [], [], "", ""
                attrs: Dict[str, Any] = {}
                for nfield, _, nval in _fields(val):
                    if nfield == 1 and isinstance(nval, bytes):
                        ins.append(nval.decode())
                    elif nfield == 2 and isinstance(nval, bytes):
                        outs.append(nval.decode())
                    elif nfield == 3 and isinstance(nval, bytes):
                        name = nval.decode()
                    elif nfield == 4 and isinstance(nval, bytes):
                        op = nval.decode()
                    elif nfield == 5 and isinstance(nval, bytes):
                        k, v = _parse_attr(nval)
                        attrs[k] = v
                nodes.append(OnnxNode(op, name, ins, outs, attrs))
            elif gfield == 5 and isinstance(val, bytes):  # initializer
                tname, arr = _parse_tensor(val)
                inits[tname] = arr
            elif gfield == 11 and isinstance(val, bytes):
                graph_inputs.append(_io_name(val))
            elif gfield == 12 and isinstance(val, bytes):
                graph_outputs.append(_io_name(val))
    return nodes, inits, graph_inputs, graph_outputs


def defuse_state_dict(
    sd: Dict[str, np.ndarray], eps: float = BN_EPS
) -> Dict[str, np.ndarray]:
    """Rebuild identity BatchNorms around fused conv biases.

    For every ``X.conv.weight`` carrying an ``X.conv.bias`` with no sibling
    ``X.bn.*`` (the fused-export signature), move the bias into a synthetic
    BN (scale 1, mean 0, var ``1 - eps``) so the ConvBN module reproduces
    ``conv(x) + bias`` exactly.  Unfused dicts pass through untouched.
    """
    out = dict(sd)
    for key in list(sd):
        if not key.endswith(".conv.weight"):
            continue
        base = key[: -len(".conv.weight")]
        bias_key = f"{base}.conv.bias"
        if f"{base}.bn.weight" in sd or bias_key not in sd:
            continue
        bias = np.asarray(out.pop(bias_key), np.float32)
        n = bias.shape[0]
        out[f"{base}.bn.weight"] = np.ones(n, np.float32)
        out[f"{base}.bn.bias"] = bias
        out[f"{base}.bn.running_mean"] = np.zeros(n, np.float32)
        out[f"{base}.bn.running_var"] = np.full(n, 1.0 - eps, np.float32)
    return out


def convert_detector_onnx(
    src: Union[str, bytes, Dict[str, np.ndarray]], depths=(1, 2, 2, 1)
):
    """ONNX detector export -> YoloLitePi variables (Flax names).

    Accepts a path, raw bytes, or pre-read initializers with
    state-dict-style names (``model.{idx}.…`` — the Ultralytics module-list
    layout, fused or unfused)."""
    from litepi_tpu_torch.weights.torch_import import convert_detector_state_dict

    inits = src if isinstance(src, dict) else read_onnx_initializers(src)
    return convert_detector_state_dict(defuse_state_dict(inits), depths)


def read_onnx_state_dict(src: Union[str, bytes]) -> Dict[str, np.ndarray]:
    """Initializers PLUS Identity-aliased names — the full state dict of a
    name-preserving export.

    Real ``torch.onnx.export`` deduplicates bit-identical initializers
    (e.g. the all-ones BatchNorm scales of a fresh model): one tensor
    survives under one state-dict name and every other occurrence becomes
    an ``Identity`` node re-materialising the aliased name.  Replaying
    those nodes recovers the complete mapping (float16 upcast as in
    :func:`read_onnx_initializers`)."""
    nodes, inits, _gi, _go = read_onnx_graph(src)
    out: Dict[str, np.ndarray] = {}
    for name, arr in inits.items():
        out[name] = arr.astype(np.float32) if arr.dtype == np.float16 else arr
    for node in nodes:
        if node.op == "Identity" and node.inputs[0] in out:
            out[node.outputs[0]] = out[node.inputs[0]]
    return out


def convert_classifier_onnx(
    arch: str, src: Union[str, bytes, Dict[str, np.ndarray]]
):
    """ONNX classifier export -> Flax-named variables.

    The reference exports its four classifiers torch -> ONNX before the
    NCNN/OpenVINO conversions (reference: src/*/convert-model-classify.ipynb
    cells 3-12); ``torch.onnx.export`` preserves the torchvision state-dict
    parameter names as graph initializers, so the existing per-arch
    converters apply directly.  Requires a name-preserving export (the
    default for these models — constant-folded exports that fuse BatchNorms
    rename their initializers and cannot be mapped back by name).
    """
    from litepi_tpu_torch.weights.torch_import import convert_classifier_state_dict

    inits = src if isinstance(src, dict) else read_onnx_state_dict(src)
    try:
        return convert_classifier_state_dict(arch, inits)
    except KeyError as e:
        raise ValueError(
            f"ONNX graph lacks initializer {e.args[0]!r} expected for "
            f"{arch!r}: the export was likely constant-folded (BatchNorms "
            "fused, initializers renamed). Re-export with "
            "do_constant_folding=False, or convert from the .pth instead."
        ) from e


def convert_classifier_onnx_traced(src: Union[str, bytes]):
    """Fused ``torch.onnx.export`` ShuffleNetV2 graph -> (deploy-form
    variables, num_classes), bound by topology instead of names.

    Real ``torch.onnx.export`` in eval mode folds every BatchNorm into its
    conv (the jit eval peephole) and renames the fused initializers to
    anonymous ``onnx::Conv_NNNN``, so no state-dict name survives for
    :func:`convert_classifier_onnx_fused` to map.  What DOES survive is
    weighted-node ORDER: the tracer emits convs in module execution order,
    which is exactly :func:`litepi_tpu_torch.weights.ncnn_import.
    shufflenet_weighted_plan` order.  Binding is therefore positional and
    type-checked node by node (depthwise iff ``group > 1``, the fc as
    ``Gemm``) — the ONNX sibling of ``convert_classifier_ncnn``'s plan
    verification (reference artifact flow: convert-model-classify.ipynb
    cells 3-4)."""
    from litepi_tpu_torch.weights.ncnn_import import (
        shufflenet_deploy_variables,
        shufflenet_weighted_plan,
    )

    nodes, inits, _gi, _go = read_onnx_graph(src)
    bn_nodes = [n.name for n in nodes if n.op == "BatchNormalization"]
    if bn_nodes:
        raise ValueError(
            "ONNX graph is not a fused export: BatchNormalization nodes "
            f"present ({bn_nodes[:2]}...); use convert_classifier_onnx."
        )
    # resolve Identity-deduplicated tensors so every node input is fetchable
    alias: Dict[str, np.ndarray] = dict(inits)
    for node in nodes:
        if node.op == "Identity" and node.inputs[0] in alias:
            alias[node.outputs[0]] = alias[node.inputs[0]]

    weighted = [n for n in nodes if n.op in ("Conv", "Gemm")]
    plan = shufflenet_weighted_plan()
    errors: List[str] = []
    if len(weighted) != len(plan):
        errors.append(
            f"weighted-node count: graph has {len(weighted)}, the "
            f"canonical ShuffleNetV2 form has {len(plan)}"
        )
    sd: Dict[str, np.ndarray] = {}
    for node, (tkey, _fpath, ltype) in zip(weighted, plan):
        w = alias.get(node.inputs[1])
        if w is None:
            errors.append(f"{node.name} -> {tkey}: weight is not constant")
            continue
        if node.op == "Gemm":
            if ltype != "InnerProduct":
                errors.append(f"{node.name} -> {tkey}: Gemm != {ltype}")
                continue
            if float(node.attrs.get("alpha", 1.0)) != 1.0 or float(
                node.attrs.get("beta", 1.0)
            ) != 1.0:
                errors.append(f"{node.name}: non-unit Gemm alpha/beta")
                continue
            if not int(node.attrs.get("transB", 0)):
                w = w.T  # canonical torch fc layout is (out, in)
        else:
            groups = int(node.attrs.get("group", 1))
            want_dw = ltype == "ConvolutionDepthWise"
            if (groups > 1) != want_dw:
                errors.append(
                    f"{node.name} -> {tkey}: group={groups} but plan "
                    f"says {ltype}"
                )
                continue
            if len(node.inputs) < 3:
                errors.append(
                    f"{node.name} -> {tkey}: fused conv carries no bias"
                )
                continue
        sd[f"{tkey}.weight"] = np.asarray(w, np.float32)
        if len(node.inputs) > 2:
            b = alias.get(node.inputs[2])
            if b is None:
                errors.append(f"{node.name} -> {tkey}: bias is not constant")
                continue
            sd[f"{tkey}.bias"] = np.asarray(b, np.float32)
    if errors:
        raise ValueError(
            "ONNX graph does not trace onto the canonical ShuffleNetV2 "
            "plan:\n  " + "\n  ".join(errors)
        )
    return shufflenet_deploy_variables(sd)


def convert_classifier_onnx_fused(src: Union[str, bytes, Dict[str, np.ndarray]]):
    """Fused (deploy-form) ShuffleNetV2 ONNX -> (``ShuffleNetV2(fused=
    True)`` variables, num_classes) — the ONNX sibling of
    :func:`litepi_tpu_torch.weights.ncnn_import.convert_classifier_ncnn`, which
    the JAX package's ``weights/onnx_export.py::export_classifier_onnx`` output
    loads back through (biased convs keyed ``conv1.0.weight`` …, no BN
    initializers)."""
    from litepi_tpu_torch.weights.ncnn_import import (
        shufflenet_deploy_variables,
        shufflenet_weighted_plan,
    )

    inits = src if isinstance(src, dict) else read_onnx_initializers(src)
    # Deploy form means every conv carries the folded-BN bias and no BN
    # statistics remain.  An UNFUSED torchvision export shares all the
    # ``.weight`` keys (its convs are bias-free, BN follows), so presence
    # of weights alone cannot distinguish the two — the 03eb66e regression.
    missing = []
    for tkey, _f, ltype in shufflenet_weighted_plan():
        if f"{tkey}.weight" not in inits:
            missing.append(f"{tkey}.weight")
        elif ltype != "InnerProduct" and f"{tkey}.bias" not in inits:
            missing.append(f"{tkey}.bias")
    if missing:
        raise ValueError(
            "ONNX graph is not a fused ShuffleNetV2 export: missing "
            f"initializers {missing[:4]}"
        )
    bn_stats = [k for k in inits if "running_mean" in k or "running_var" in k]
    if bn_stats:
        raise ValueError(
            "ONNX graph is not a fused ShuffleNetV2 export: BatchNorm "
            f"statistics present ({bn_stats[:2]}...) — this is an unfused "
            "training-form graph; use convert_classifier_onnx instead."
        )
    return shufflenet_deploy_variables(inits)


def run_onnx_graph(
    nodes: List[OnnxNode],
    inits: Dict[str, np.ndarray],
    feeds: Dict[str, np.ndarray],
    device="cuda",
):
    """Execute a graph on numpy feeds (NCHW, batch dim included),
    returning ``{name: numpy array}`` for the feeds and every produced blob.

    The op set of the detector exports, the ShuffleNetV2 classifier
    emission and real ``torch.onnx.export`` classifier graphs (Constant,
    Shape, Gather, Unsqueeze, Identity, Clip, BatchNormalization, Flatten
    beside the detectors' ops).  Every op runs as torch ops on ``device``
    (default the card; it raises without one), float32 with TF32 off; the
    convolutions through ``F.conv2d``, shape arithmetic on small integer
    tensors.  The JAX package's ``run_onnx_graph`` computes the same with
    XLA convolutions and numpy.
    """
    dev = resolve_device(device)
    blobs: Dict[str, torch.Tensor] = {k: gops.tensor(v, dev) for k, v in feeds.items()}
    consts: Dict[str, torch.Tensor] = {}

    def get(name: str) -> torch.Tensor:
        if name in blobs:
            return blobs[name]
        if name not in consts:
            consts[name] = gops.tensor(inits[name], dev)
        return consts[name]

    def ints(name: str) -> List[int]:
        return [int(v) for v in get(name).reshape(-1).tolist()]

    with gops.float32_exact():
        for node in nodes:
            op = node.op
            out = node.outputs[0] if node.outputs else None
            if op == "Conv":
                x, w = get(node.inputs[0]), get(node.inputs[1])
                pads = node.attrs.get("pads", [0, 0, 0, 0])
                y = gops.conv2d(
                    x, w, node.attrs.get("strides", [1, 1]),
                    ((pads[0], pads[2]), (pads[1], pads[3])),
                    node.attrs.get("dilations", [1, 1]), int(node.attrs.get("group", 1)),
                )
                if len(node.inputs) > 2:
                    y = y + get(node.inputs[2]).reshape(1, -1, 1, 1)
                blobs[out] = y
            elif op == "Sigmoid":
                blobs[out] = gops.sigmoid(get(node.inputs[0]))
            elif op == "Relu":
                blobs[out] = torch.clamp_min(get(node.inputs[0]), 0.0)
            elif op == "ReduceMean":
                axes = node.attrs.get("axes")
                if axes is None and len(node.inputs) > 1:  # opset>=18 form
                    axes = ints(node.inputs[1])
                blobs[out] = get(node.inputs[0]).mean(
                    dim=tuple(int(a) for a in axes),
                    keepdim=bool(int(node.attrs.get("keepdims", 1))),
                )
            elif op == "Gemm":
                a, b = get(node.inputs[0]), get(node.inputs[1])
                if int(node.attrs.get("transA", 0)):
                    a = a.T
                if int(node.attrs.get("transB", 0)):
                    b = b.T
                y = float(node.attrs.get("alpha", 1.0)) * (a @ b)
                if len(node.inputs) > 2:
                    y = y + float(node.attrs.get("beta", 1.0)) * get(node.inputs[2])
                blobs[out] = y
            elif op in ("Mul", "Add", "Sub", "Div"):
                fn = {"Mul": torch.mul, "Add": torch.add, "Sub": torch.sub, "Div": torch.div}[op]
                blobs[out] = fn(get(node.inputs[0]), get(node.inputs[1]))
            elif op == "Concat":
                blobs[out] = torch.cat([get(i) for i in node.inputs],
                                       dim=int(node.attrs["axis"]))
            elif op == "Split":
                x = get(node.inputs[0])
                sizes = node.attrs.get("split")
                if sizes is None and len(node.inputs) > 1:  # opset>=13 form
                    sizes = ints(node.inputs[1])
                pieces = gops.split(x, int(node.attrs["axis"]), sizes)
                for name, piece in zip(node.outputs, pieces):
                    blobs[name] = piece
            elif op == "Reshape":
                x = get(node.inputs[0])
                shape = [x.shape[i] if d == 0 else d for i, d in enumerate(ints(node.inputs[1]))]
                blobs[out] = x.reshape(shape)
            elif op == "Transpose":
                blobs[out] = get(node.inputs[0]).permute(list(node.attrs["perm"]))
            elif op == "Softmax":
                blobs[out] = gops.softmax(get(node.inputs[0]), int(node.attrs.get("axis", -1)))
            elif op == "MaxPool":
                kh, kw = node.attrs["kernel_shape"]
                pads = node.attrs.get("pads", [0, 0, 0, 0])
                if int(node.attrs.get("ceil_mode", 0)):
                    raise ValueError(f"{node.name}: ceil_mode unsupported")
                blobs[out] = gops.max_pool(
                    get(node.inputs[0]), (kh, kw), node.attrs.get("strides", [1, 1]),
                    ((pads[0], pads[2]), (pads[1], pads[3])),
                )
            elif op == "Resize":
                if node.attrs.get("mode", "nearest") != "nearest":
                    raise ValueError(f"{node.name}: only nearest Resize")
                scales = get(node.inputs[2]).tolist()
                blobs[out] = gops.repeat_nearest(
                    get(node.inputs[0]), ((2, int(scales[2])), (3, int(scales[3]))))
            elif op == "Constant":
                val = node.attrs.get("value")
                if val is None:  # value_float / value_int single-scalar forms
                    for k in ("value_float", "value_int"):
                        if k in node.attrs:
                            val = np.asarray(node.attrs[k])
                            break
                if val is None:
                    raise ValueError(f"{node.name}: Constant without value")
                blobs[out] = gops.tensor(np.asarray(val), dev)
            elif op == "Identity":
                blobs[out] = get(node.inputs[0])
            elif op == "Shape":
                blobs[out] = torch.tensor(list(get(node.inputs[0]).shape),
                                          dtype=torch.int64, device=dev)
            elif op == "Gather":
                blobs[out] = gops.take(get(node.inputs[0]), get(node.inputs[1]),
                                       int(node.attrs.get("axis", 0)))
            elif op == "Unsqueeze":
                axes = node.attrs.get("axes")
                if axes is None:  # opset>=13: axes as second input
                    axes = ints(node.inputs[1])
                y = get(node.inputs[0])
                for a in sorted(int(a) for a in axes):
                    y = y.unsqueeze(a if a >= 0 else a + y.dim() + 1)
                blobs[out] = y
            elif op == "Flatten":
                x = get(node.inputs[0])
                axis = int(node.attrs.get("axis", 1))
                lead = int(np.prod(x.shape[:axis])) if axis else 1
                blobs[out] = x.reshape(lead, -1)
            elif op == "Clip":
                x = get(node.inputs[0])
                lo = (get(node.inputs[1]) if len(node.inputs) > 1 and node.inputs[1]
                      else node.attrs.get("min"))
                hi = (get(node.inputs[2]) if len(node.inputs) > 2 and node.inputs[2]
                      else node.attrs.get("max"))
                if lo is not None:
                    x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype, device=dev))
                if hi is not None:
                    x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype, device=dev))
                blobs[out] = x
            elif op == "BatchNormalization":
                x = get(node.inputs[0])
                scale, bias, mean, var = (get(i) for i in node.inputs[1:5])
                eps = float(node.attrs.get("epsilon", 1e-5))
                shp = (1, -1) + (1,) * (x.dim() - 2)
                blobs[out] = ((x - mean.reshape(shp)) / torch.sqrt(var.reshape(shp) + eps)
                              * scale.reshape(shp) + bias.reshape(shp))
            elif op == "Slice":
                x = get(node.inputs[0])
                starts, ends = ints(node.inputs[1]), ints(node.inputs[2])
                axes = (ints(node.inputs[3]) if len(node.inputs) > 3 and node.inputs[3]
                        else list(range(len(starts))))
                steps = (ints(node.inputs[4]) if len(node.inputs) > 4 and node.inputs[4]
                         else [1] * len(starts))
                sl = [slice(None)] * x.dim()
                for st, en, a, step in zip(starts, ends, axes, steps):
                    sl[a if a >= 0 else a + x.dim()] = slice(st, en, step)
                blobs[out] = x[tuple(sl)]
            else:
                raise ValueError(f"unsupported ONNX op {op!r} ({node.name})")
    return {k: gops.to_numpy(v) for k, v in blobs.items()}
