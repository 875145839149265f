"""OpenVINO IR (``.xml`` + ``.bin``) ingestion (numpy and ``xml`` only).

The port's copy of the JAX package's ``weights/openvino_import.py``.  It
returns numpy variable trees with the Flax names, as the JAX importer
does; its graph interpreter :func:`run_ir_graph` (the emitters' oracle)
runs torch ops on a device.

The IR is plain XML over a flat weight blob: ``Const`` layers carry
``offset``/``size``/``shape``/``element_type`` into the ``.bin`` (fp16
constants, the ``ovc`` default, are widened to float32).  Conv *weights*
keep their torch names (``self.model.0.conv.weight``), so they map
straight onto the shared state-dict converter; conv *biases* are
anonymous Consts feeding an ``Add`` right after each ``Convolution``, and
are recovered by walking the edge list (the module path is parsed out of
the Convolution layer's ``__module.model.X…/aten::_convolution`` name).
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from litepi_tpu_torch.core.device import resolve_device
from litepi_tpu_torch.core.types import DetectorConfig
from litepi_tpu_torch.weights import graph_ops as gops

_ELEMENT_DTYPES = {
    "f32": np.float32,
    "f16": np.float16,
    "f64": np.float64,
    "i64": np.int64,
    "i32": np.int32,
    "i8": np.int8,
    "u8": np.uint8,
    "boolean": np.bool_,
}


@dataclasses.dataclass
class IrLayer:
    id: int
    name: str
    type: str
    data: Dict[str, str]


@dataclasses.dataclass
class IrGraph:
    layers: Dict[int, IrLayer]
    # consumer map: from_layer -> [(to_layer, to_port)]
    consumers: Dict[int, List[Tuple[int, int]]]
    # producer map: (to_layer, to_port) -> from_layer
    producers: Dict[Tuple[int, int], int]
    # port-exact producer map: (to_layer, to_port) -> (from_layer, from_port)
    # (multi-output layers — VariadicSplit, MaxPool — need the from-port to
    # execute; weight recovery above only needs the from-layer)
    sources: Dict[Tuple[int, int], Tuple[int, int]] = dataclasses.field(
        default_factory=dict
    )


def parse_openvino_xml(xml_path: str) -> IrGraph:
    root = ET.parse(xml_path).getroot()
    layers: Dict[int, IrLayer] = {}
    for el in root.find("layers"):
        lid = int(el.get("id"))
        data_el = el.find("data")
        layers[lid] = IrLayer(
            lid,
            el.get("name", ""),
            el.get("type", ""),
            dict(data_el.attrib) if data_el is not None else {},
        )
    consumers: Dict[int, List[Tuple[int, int]]] = {}
    producers: Dict[Tuple[int, int], int] = {}
    sources: Dict[Tuple[int, int], Tuple[int, int]] = {}
    for e in root.find("edges"):
        f, fp, t, tp = (
            int(e.get("from-layer")),
            int(e.get("from-port")),
            int(e.get("to-layer")),
            int(e.get("to-port")),
        )
        consumers.setdefault(f, []).append((t, tp))
        producers[(t, tp)] = f
        sources[(t, tp)] = (f, fp)
    return IrGraph(layers, consumers, producers, sources)


def _const_array(layer: IrLayer, blob: bytes) -> np.ndarray:
    dtype = _ELEMENT_DTYPES.get(layer.data.get("element_type"))
    if dtype is None:
        raise ValueError(
            f"{layer.name}: unsupported element_type "
            f"{layer.data.get('element_type')!r}"
        )
    off, size = int(layer.data["offset"]), int(layer.data["size"])
    shape_txt = layer.data.get("shape")
    shape = tuple(
        int(s) for s in (shape_txt or "").replace(" ", "").split(",") if s
    )
    arr = np.frombuffer(blob[off : off + size], dtype=dtype)
    if shape:
        return arr.reshape(shape)
    # shape="" (attribute present but empty) is the IR's scalar encoding —
    # e.g. a VariadicSplit axis Const; a missing attribute keeps the flat read
    return arr.reshape(()) if shape_txt == "" else arr


def _module_path(conv_name: str) -> Optional[str]:
    """``__module.model.4.cv1.conv/aten::_convolution/Convolution`` ->
    ``model.4.cv1.conv`` (None if the layer is not a torch conv)."""
    if not conv_name.startswith("__module."):
        return None
    return conv_name[len("__module.") :].split("/", 1)[0]


def openvino_state_dict(
    xml_path: str, bin_path: str, graph: Optional[IrGraph] = None
) -> Dict[str, np.ndarray]:
    """IR -> Ultralytics-style (fused) state dict.

    Weights come from the named Consts; biases from the Add that consumes
    each Convolution's output (shape ``(1, C, 1, 1)`` Const, C = the conv's
    out-channels).  fp16 IRs upcast to float32.  ``graph`` reuses an
    already-parsed IR (the e2e CLI parses once at its topology probe).
    """
    g = graph if graph is not None else parse_openvino_xml(xml_path)
    blob = open(bin_path, "rb").read()
    sd: Dict[str, np.ndarray] = {}
    for layer in g.layers.values():
        if layer.type == "Const" and layer.name.startswith("self.model."):
            arr = _const_array(layer, blob)
            if arr.dtype == np.float16:
                arr = arr.astype(np.float32)
            sd[layer.name[len("self.") :]] = arr
    for layer in g.layers.values():
        if layer.type not in ("Convolution", "GroupConvolution"):
            continue
        path = _module_path(layer.name)
        if path is None:
            continue
        if layer.type == "GroupConvolution":
            # depthwise weights are anonymous Consts (no ``self.model.*``
            # name) — recover them through the conv's port-1 producer and
            # flatten the 5-D (g, out/g, in/g, k, k) grouped layout to the
            # torch depthwise (out, in/g, k, k) the converters expect
            w = g.producers.get((layer.id, 1))
            if w is not None and g.layers[w].type == "Convert":
                w = g.producers.get((w, 0))
            if w is not None and g.layers[w].type == "Const":
                arr = _const_array(g.layers[w], blob)
                if arr.dtype == np.float16:
                    arr = arr.astype(np.float32)
                if arr.ndim == 5:
                    arr = arr.reshape(
                        arr.shape[0] * arr.shape[1], *arr.shape[2:]
                    )
                sd[f"{path}.weight"] = arr
        for to_layer, to_port in g.consumers.get(layer.id, []):
            consumer = g.layers[to_layer]
            if consumer.type != "Add":
                continue
            other = g.producers.get((to_layer, 1 - to_port))
            if other is not None and g.layers[other].type == "Convert":
                # fp16-compressed IRs (compress_to_fp16, the ovc default)
                # decompress weights through Const -> Convert -> Add;
                # follow the one hop back to the Const
                other = g.producers.get((other, 0))
            if other is None or g.layers[other].type != "Const":
                continue
            bias = _const_array(g.layers[other], blob)
            if bias.ndim == 4 and bias.shape[0] == 1 and bias.shape[2:] == (1, 1):
                if bias.dtype == np.float16:
                    bias = bias.astype(np.float32)
                key = f"{path}.bias"
                # torch bare convs (head 1x1s) name the module itself;
                # ConvBN convs name the `.conv` child — path already
                # carries whichever, so the key lines up with the weight
                sd[key] = bias.reshape(-1)
    return sd


def verify_openvino_topology(
    xml_path: str, cfg: DetectorConfig, graph: Optional[IrGraph] = None
) -> None:
    """Check the IR's convolution set against ``cfg``: every expected
    module path must appear with the expected (out, in-divisible, k, k)
    weight shape, and the conv count must match the canonical plan
    (reference: yolo_plus.xml:4-7 declares the (1,3,640,640) Parameter)."""
    from litepi_tpu_torch.weights.ncnn_import import ultralytics_conv_plan

    g = graph if graph is not None else parse_openvino_xml(xml_path)
    plan = ultralytics_conv_plan(cfg)
    convs = [l for l in g.layers.values() if l.type == "Convolution"]
    errors: List[str] = []
    if len(convs) != len(plan):
        errors.append(
            f"conv count: IR has {len(convs)}, config expects {len(plan)}"
        )
    # weight shapes by name (Const shape attr — no .bin needed)
    shapes: Dict[str, Tuple[int, ...]] = {}
    for l in g.layers.values():
        if l.type == "Const" and l.name.startswith("self.model."):
            shape = tuple(
                int(s)
                for s in l.data.get("shape", "").replace(" ", "").split(",")
                if s
            )
            shapes[l.name[len("self.") :]] = shape
    for path, out_c, k in plan:
        if path == "model.22.dfl":
            continue  # DFL weight is an anonymous folded Const in the IR
        is_bare = path.startswith("model.22.") and path.endswith(".2")
        key = f"{path}.weight" if is_bare else f"{path}.conv.weight"
        shape = shapes.get(key)
        if shape is None:
            errors.append(f"missing IR Const {key}")
        elif shape[0] != out_c or shape[2:] != (k, k):
            errors.append(
                f"{key}: IR shape {shape}, config expects "
                f"({out_c}, ·, {k}, {k})"
            )
    if errors:
        raise ValueError(
            f"OpenVINO IR does not match config {cfg.name!r}:\n  "
            + "\n  ".join(errors)
        )


def verify_openvino_variant_topology(
    xml_path: str,
    variant: str,
    num_classes: int = 1,
    graph: Optional[IrGraph] = None,
) -> None:
    """Check a baseline IR ('yolov5nu'/'yolov11n') against its canonical
    conv plan — the OpenVINO sibling of
    :func:`litepi_tpu_torch.weights.ncnn_import.verify_ncnn_variant_topology`
    (artifacts: src/*/convert/model/yolo{5,11}/*_openvino_model/*.xml;
    their .bins are stripped upstream, so shape parity is what is
    checkable).  Regular conv weights are named Consts; depthwise weights
    are anonymous, so those are located through their GroupConvolution
    layer's ``__module.<path>.conv`` name and checked via the weight
    Const's 5-D ``(g, out/g, in/g, k, k)`` shape."""
    from litepi_tpu_torch.weights.ncnn_import import _VARIANT_PLANS

    plan_fn, head = _VARIANT_PLANS[variant]
    plan = plan_fn(num_classes)
    g = graph if graph is not None else parse_openvino_xml(xml_path)
    convs = [
        l for l in g.layers.values()
        if l.type in ("Convolution", "GroupConvolution")
    ]
    errors: List[str] = []
    if len(convs) != len(plan):
        errors.append(
            f"conv count: IR has {len(convs)}, plan expects {len(plan)}"
        )
    shapes: Dict[str, Tuple[int, ...]] = {}
    for l in g.layers.values():
        if l.type == "Const" and l.name.startswith("self.model."):
            shape = tuple(
                int(s)
                for s in l.data.get("shape", "").replace(" ", "").split(",")
                if s
            )
            shapes[l.name[len("self.") :]] = shape
    group_layers = {
        l.name: l for l in g.layers.values() if l.type == "GroupConvolution"
    }
    for entry in plan:
        path, out_c, k = entry[:3]
        groups = entry[3] if len(entry) > 3 else 1
        if path == f"model.{head}.dfl":
            continue  # folded range conv; constant, not a weight
        if groups > 1:
            match = [
                l for name, l in group_layers.items()
                if name.startswith(f"__module.{path}.conv/")
            ]
            if not match:
                errors.append(f"missing GroupConvolution for {path}")
                continue
            w = g.producers.get((match[0].id, 1))
            if w is not None and g.layers[w].type == "Convert":
                w = g.producers.get((w, 0))
            shape = ()
            if w is not None and g.layers[w].type == "Const":
                shape = tuple(
                    int(s)
                    for s in g.layers[w].data.get("shape", "")
                    .replace(" ", "").split(",") if s
                )
            if (
                len(shape) != 5
                or shape[0] != groups
                or shape[0] * shape[1] != out_c
                or shape[3:] != (k, k)
            ):
                errors.append(
                    f"{path}: depthwise weight shape {shape}, expected "
                    f"({groups}, {out_c // groups}, ·, {k}, {k})"
                )
            continue
        is_bare = path.startswith(f"model.{head}.") and path.endswith(".2")
        key = f"{path}.weight" if is_bare else f"{path}.conv.weight"
        shape = shapes.get(key)
        if shape is None:
            errors.append(f"missing IR Const {key}")
        elif shape[0] != out_c or shape[2:] != (k, k):
            errors.append(
                f"{key}: IR shape {shape}, plan expects ({out_c}, ·, {k}, {k})"
            )
    if errors:
        raise ValueError(
            f"OpenVINO IR does not match variant {variant!r}:\n  "
            + "\n  ".join(errors)
        )


def convert_detector_openvino(
    xml_path: str,
    bin_path: str,
    cfg: Optional[DetectorConfig] = None,
    graph: Optional[IrGraph] = None,
):
    """OpenVINO IR -> (YoloLitePi variables, matched config).

    Covers the yolo_plus v2/v1 and stock-yolov8n IRs (all share the
    model.22 head layout); with ``cfg=None`` the matching config is
    inferred from the IR's conv shapes."""
    from litepi_tpu_torch.core.types import YOLO_PLUS_V1, YOLO_PLUS_V2, YOLOV8N
    from litepi_tpu_torch.weights.onnx_import import defuse_state_dict
    from litepi_tpu_torch.weights.torch_import import convert_detector_state_dict

    if graph is None:
        graph = parse_openvino_xml(xml_path)
    if cfg is None:
        errs = []
        for cand in (YOLO_PLUS_V2, YOLO_PLUS_V1, YOLOV8N):
            try:
                verify_openvino_topology(xml_path, cand, graph=graph)
                cfg = cand
                break
            except ValueError as e:
                errs.append(str(e).splitlines()[0])
        if cfg is None:
            raise ValueError(
                "IR matches no yolo_plus/yolov8n config: " + "; ".join(errs)
            )
    else:
        verify_openvino_topology(xml_path, cfg, graph=graph)
    sd = defuse_state_dict(openvino_state_dict(xml_path, bin_path, graph=graph))
    return convert_detector_state_dict(sd, cfg.depths), cfg


def convert_detector_openvino_variant(
    xml_path: str,
    bin_path: str,
    variant: str,
    num_classes: int = 1,
    graph: Optional[IrGraph] = None,
):
    """Baseline-variant IR ('yolov5nu'/'yolov11n') -> Flax variables for
    YoloV5(anchor_free=True) / YoloV11 — the OpenVINO sibling of
    :func:`litepi_tpu_torch.weights.ncnn_import.convert_detector_ncnn_variant`
    (artifacts: src/*/convert/model/yolo{5,11}/*_openvino_model/)."""
    from litepi_tpu_torch.weights.ncnn_import import variant_state_converter
    from litepi_tpu_torch.weights.onnx_import import defuse_state_dict

    if graph is None:
        graph = parse_openvino_xml(xml_path)
    verify_openvino_variant_topology(
        xml_path, variant, num_classes, graph=graph
    )
    sd = defuse_state_dict(openvino_state_dict(xml_path, bin_path, graph=graph))
    return variant_state_converter(variant)(sd)


def convert_classifier_openvino_fused(
    xml_path: str, bin_path: str, graph: Optional[IrGraph] = None
):
    """Fused (deploy-form) ShuffleNetV2 IR -> (``ShuffleNetV2(fused=
    True)`` variables, num_classes) — the OpenVINO sibling of
    :func:`litepi_tpu_torch.weights.ncnn_import.convert_classifier_ncnn`, which
    the JAX package's ``weights/openvino_export.py::export_classifier_openvino``
    output loads back through.  Regular conv weights are named Consts
    (``self.conv1.0.weight`` …); depthwise weights are anonymous 5-D
    grouped Consts reached through their GroupConvolution; biases are the
    Add-consumer Consts; the fc is a MatMul(transpose_b) + Add pair."""
    from litepi_tpu_torch.weights.ncnn_import import (
        shufflenet_deploy_variables,
        shufflenet_weighted_plan,
    )

    g = graph if graph is not None else parse_openvino_xml(xml_path)
    blob = open(bin_path, "rb").read()
    sd: Dict[str, np.ndarray] = {}
    for layer in g.layers.values():
        if layer.type == "Const" and layer.name.startswith("self."):
            arr = _const_array(layer, blob)
            if arr.dtype == np.float16:
                arr = arr.astype(np.float32)
            sd[layer.name[len("self.") :]] = arr
    for layer in g.layers.values():
        if layer.type not in ("Convolution", "GroupConvolution", "MatMul"):
            continue
        path = _module_path(layer.name)
        if path is None:
            continue
        if path.endswith(".conv"):  # torch-trace '<module>.conv' suffix
            path = path[: -len(".conv")]
        if layer.type == "GroupConvolution":
            w = g.producers.get((layer.id, 1))
            if w is not None and g.layers[w].type == "Convert":
                w = g.producers.get((w, 0))
            if w is not None and g.layers[w].type == "Const":
                arr = _const_array(g.layers[w], blob)
                if arr.dtype == np.float16:
                    arr = arr.astype(np.float32)
                if arr.ndim == 5:
                    arr = arr.reshape(
                        arr.shape[0] * arr.shape[1], *arr.shape[2:]
                    )
                sd[f"{path}.weight"] = arr
        for to_layer, to_port in g.consumers.get(layer.id, []):
            consumer = g.layers[to_layer]
            if consumer.type != "Add":
                continue
            other = g.producers.get((to_layer, 1 - to_port))
            if other is not None and g.layers[other].type == "Convert":
                other = g.producers.get((other, 0))
            if other is None or g.layers[other].type != "Const":
                continue
            bias = _const_array(g.layers[other], blob)
            is_conv_bias = (
                bias.ndim == 4 and bias.shape[0] == 1
                and bias.shape[2:] == (1, 1)
            )
            is_fc_bias = layer.type == "MatMul" and bias.ndim == 2
            if is_conv_bias or is_fc_bias:
                if bias.dtype == np.float16:
                    bias = bias.astype(np.float32)
                sd[f"{path}.bias"] = bias.reshape(-1)
    missing = [
        f"{tkey}.weight"
        for tkey, _f, _t in shufflenet_weighted_plan()
        if f"{tkey}.weight" not in sd
    ]
    if missing:
        raise ValueError(
            "OpenVINO IR is not a fused ShuffleNetV2 export: missing "
            f"weights {missing[:4]}"
        )
    return shufflenet_deploy_variables(sd)


# IR element types of the interpreter's integer and bool dataflow
_TORCH_DTYPES = {
    "f32": torch.float32, "f16": torch.float16, "f64": torch.float64,
    "i64": torch.int64, "i32": torch.int32, "i8": torch.int8, "u8": torch.uint8,
    "boolean": torch.bool,
}


def _topo_order(g: IrGraph) -> List[int]:
    """Layer ids in dependency order (Kahn over the port-exact edges)."""
    indeg = {lid: 0 for lid in g.layers}
    outs: Dict[int, List[int]] = {lid: [] for lid in g.layers}
    for (t, _tp), (f, _fp) in g.sources.items():
        indeg[t] += 1
        outs[f].append(t)
    ready = sorted(lid for lid, d in indeg.items() if d == 0)
    order: List[int] = []
    while ready:
        lid = ready.pop()
        order.append(lid)
        for t in outs[lid]:
            indeg[t] -= 1
            if indeg[t] == 0:
                ready.append(t)
    if len(order) != len(g.layers):
        raise ValueError("IR graph contains a cycle")
    return order


def run_ir_graph(
    graph: Union[str, IrGraph],
    blob: Union[str, bytes],
    x: np.ndarray,
    return_values: bool = False,
    device="cuda",
):
    """Execute an OpenVINO IR on one (1, 3, H, W) float input, returning
    the (first) ``Result`` layer's input as numpy (with ``return_values``,
    also every ``(layer, port)`` value as numpy).

    The op vocabulary of the detector IRs (Convolution, Add, Swish, Concat,
    VariadicSplit, MaxPool, Interpolate, Reshape, Transpose, SoftMax,
    Sigmoid and the ``chunk(2)`` ShapeOf/Gather/Divide/Mod/Greater/Convert
    subgraph), GroupConvolution and MatMul for the baseline IRs, and the
    classifier emission's ReLU and ReduceMean.  Every op runs as torch ops
    on ``device`` (default the card; it raises without one), float32 with
    TF32 off; the convolutions through ``F.conv2d``, shape arithmetic on
    small integer tensors.  The JAX package's ``run_ir_graph`` computes the
    same with XLA convolutions and numpy.
    """
    dev = resolve_device(device)
    g = graph if isinstance(graph, IrGraph) else parse_openvino_xml(graph)
    if isinstance(blob, bytes):
        data = blob
    else:
        with open(blob, "rb") as f:
            data = f.read()

    def _ints(layer: IrLayer, key: str, default="") -> Tuple[int, ...]:
        txt = layer.data.get(key, default)
        return tuple(int(s) for s in txt.replace(" ", "").split(",") if s)

    def ints(t: torch.Tensor) -> List[int]:
        return [int(v) for v in t.reshape(-1).tolist()]

    # per-layer sorted input ports (port-id order == operand order)
    in_ports: Dict[int, List[int]] = {}
    for (t, tp) in g.sources:
        in_ports.setdefault(t, []).append(tp)
    for ports in in_ports.values():
        ports.sort()

    values: Dict[Tuple[int, int], torch.Tensor] = {}
    results: List[torch.Tensor] = []
    binary = {"Add": torch.add, "Subtract": torch.sub, "Multiply": torch.mul,
              "Mod": torch.remainder, "Greater": torch.gt}

    with gops.float32_exact():
        for lid in _topo_order(g):
            layer = g.layers[lid]
            t = layer.type
            ports = in_ports.get(lid, [])
            ins = [values[g.sources[(lid, p)]] for p in ports]
            key = (lid, (ports[-1] + 1) if ports else 0)

            if t == "Parameter":
                shape = _ints(layer, "shape")
                arr = np.asarray(x, np.float32)
                if shape and tuple(arr.shape) != shape:
                    raise ValueError(f"input shape {arr.shape} != Parameter shape {shape}")
                values[(lid, 0)] = gops.tensor(arr, dev)
            elif t == "Const":
                values[(lid, 0)] = gops.tensor(_const_array(layer, data), dev)
            elif t in ("Convolution", "GroupConvolution"):
                w = ins[1]
                groups = 1
                if t == "GroupConvolution":  # (g, out/g, in/g, k, k)
                    groups = w.shape[0]
                    w = w.reshape(w.shape[0] * w.shape[1], *w.shape[2:])
                pb, pe = _ints(layer, "pads_begin"), _ints(layer, "pads_end")
                values[key] = gops.conv2d(
                    ins[0], w, _ints(layer, "strides", "1,1"),
                    ((pb[0], pe[0]), (pb[1], pe[1])), _ints(layer, "dilations", "1,1"), groups,
                )
            elif t == "Divide":
                a, b = ins
                if not a.dtype.is_floating_point:
                    # m_pythondiv: traced from python // on ints
                    values[key] = torch.div(a, b, rounding_mode="floor")
                else:
                    values[key] = torch.div(a, b)
            elif t in binary:
                values[key] = binary[t](*ins)
            elif t == "Swish":
                values[key] = gops.swish(ins[0])
            elif t == "ReLU":
                values[key] = torch.clamp_min(ins[0], 0.0)
            elif t == "ReduceMean":
                keep = layer.data.get("keep_dims", "true") == "true"
                values[key] = ins[0].mean(dim=tuple(ints(ins[1])), keepdim=keep)
            elif t == "Sigmoid":
                values[key] = gops.sigmoid(ins[0])
            elif t == "SoftMax":
                values[key] = gops.softmax(ins[0], int(layer.data["axis"]))
            elif t == "Concat":
                values[key] = torch.cat(ins, dim=int(layer.data["axis"]))
            elif t == "VariadicSplit":
                x_ = ins[0]
                axis = ints(ins[1])[0]
                sizes = ints(ins[2])
                if -1 in sizes:
                    rest = x_.shape[axis] - sum(s for s in sizes if s >= 0)
                    sizes[sizes.index(-1)] = rest
                for i, piece in enumerate(gops.split(x_, axis, sizes)):
                    values[(lid, key[1] + i)] = piece
            elif t == "MatMul":
                a, b = ins
                if layer.data.get("transpose_a") == "true":
                    a = a.transpose(-1, -2)
                if layer.data.get("transpose_b") == "true":
                    b = b.transpose(-1, -2)
                values[key] = torch.matmul(a, b)
            elif t == "Reshape":
                values[key] = ins[0].reshape(ints(ins[1]))
            elif t == "Transpose":
                values[key] = ins[0].permute(ints(ins[1]))
            elif t == "MaxPool":
                if layer.data.get("rounding_type", "floor") != "floor":
                    raise ValueError(f"{layer.name}: only floor rounding")
                pb, pe = _ints(layer, "pads_begin"), _ints(layer, "pads_end")
                values[key] = gops.max_pool(
                    ins[0], _ints(layer, "kernel"), _ints(layer, "strides", "1,1"),
                    ((pb[0], pe[0]), (pb[1], pe[1])),
                )
                # port key+1 (argmax indices) exists in opset14 MaxPool but
                # nothing in the detector graphs consumes it: left unproduced
            elif t == "Interpolate":
                if layer.data.get("mode") != "nearest":
                    raise ValueError(f"{layer.name}: only nearest Interpolate")
                scales = [float(v) for v in ins[1].reshape(-1).tolist()]
                for s in scales:
                    if s != int(s):
                        raise ValueError(f"{layer.name}: non-integer scale {s}")
                values[key] = gops.repeat_nearest(
                    ins[0], [(a, int(s)) for s, a in zip(scales, ints(ins[2]))])
            elif t == "ShapeOf":
                dt = _TORCH_DTYPES[layer.data.get("output_type", "i64")]
                values[key] = torch.tensor(list(ins[0].shape), dtype=dt, device=dev)
            elif t == "Gather":
                values[key] = gops.take(ins[0], ins[1], ints(ins[2])[0])
            elif t == "Convert":
                values[key] = ins[0].to(_TORCH_DTYPES[layer.data["destination_type"]])
            elif t == "Result":
                results.append(ins[0])
            else:
                raise ValueError(f"unsupported IR layer type {t!r} ({layer.name})")

    if not results:
        raise ValueError("IR graph has no Result layer")
    if return_values:
        return gops.to_numpy(results[0]), {k: gops.to_numpy(v) for k, v in values.items()}
    return gops.to_numpy(results[0])
