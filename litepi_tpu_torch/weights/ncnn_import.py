"""NCNN ``.param``/``.bin`` graph ingestion (numpy only), and the graph
interpreter in torch.

The port's copy of the JAX package's ``weights/ncnn_import.py``.  It
returns what the JAX importer returns: numpy variable trees with the Flax
names, which ``TwoStagePipeline.from_jax_vars`` carries into the port's
modules through ``weights/jax_bridge.py``.

The reference deploys NCNN graphs (its ``model.ncnn.param`` +
``model.ncnn.bin``).  Both files are read off their text and wire formats:

* :func:`parse_ncnn_param` — the graph text (magic 7767517,
  ``Type name bottom_count top_count bottoms tops k=v...`` rows, array
  attrs keyed ``-(23300+id)`` with a leading element count);
* :func:`read_ncnn_bin` — per-layer weights in declaration order
  (Convolution: u32 dtype tag + weight data + raw-fp32 bias;
  MemoryData: raw fp32, no tag), refusing a mispaired ``.bin``;
* :func:`verify_ncnn_topology` — checks a
  :class:`~litepi_tpu_torch.core.types.DetectorConfig` layer by layer
  against the graph (conv out-channels/kernel/weight size in pnnx
  emission order, the box/class split and the 16-bin DFL reshape) and
  returns the conv -> Ultralytics-name map;
* :func:`convert_detector_ncnn` — graph + weights -> YoloLitePi variables
  through the shared state-dict converter; the yolov5nu / yolov11n
  baselines through :func:`convert_detector_ncnn_variant`;
* :func:`convert_classifier_ncnn` — a ShuffleNetV2 pair -> deploy-form
  classifier variables;
* :func:`run_ncnn_graph` — the graph executed with torch ops on a device
  (the JAX package's numpy + XLA interpreter, the emitters' oracle).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from litepi_tpu_torch.core.device import resolve_device
from litepi_tpu_torch.core.types import DetectorConfig
from litepi_tpu_torch.weights import graph_ops as gops

# NCNN ModelBin dtype tags (u32 little-endian before each conv weight blob)
_TAG_FP32 = 0
_TAG_FP16 = 0x01306B47
_TAG_INT8 = 0x000D4B38
_TAG_RAW32 = 0x0002C056  # fp32 stored without conversion


@dataclasses.dataclass
class NcnnLayer:
    type: str
    name: str
    bottoms: List[str]
    tops: List[str]
    attrs: Dict[int, Union[int, float, List[float]]]
    weights: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def attr(self, key: int, default=None):
        return self.attrs.get(key, default)


def _parse_value(tok: str) -> Union[int, float]:
    if "." in tok or "e" in tok or "E" in tok or "inf" in tok:
        return float(tok)
    return int(tok)


def parse_ncnn_param(src: Union[str, bytes]) -> List[NcnnLayer]:
    """Parse a ``.param`` graph text into layers (declaration order)."""
    if isinstance(src, bytes):
        text = src.decode("utf-8")
    elif "\n" in src:
        text = src
    else:
        with open(src, "r") as f:
            text = f.read()
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if _parse_value(lines[0].strip()) != 7767517:
        raise ValueError(f"not an NCNN param file (magic {lines[0]!r})")
    layer_count, _blob_count = (int(t) for t in lines[1].split())
    layers: List[NcnnLayer] = []
    for ln in lines[2 : 2 + layer_count]:
        toks = ln.split()
        ltype, name = toks[0], toks[1]
        nb, nt = int(toks[2]), int(toks[3])
        bottoms = toks[4 : 4 + nb]
        tops = toks[4 + nb : 4 + nb + nt]
        attrs: Dict[int, Union[int, float, List[float]]] = {}
        for kv in toks[4 + nb + nt :]:
            k, v = kv.split("=", 1)
            key = int(k)
            if key <= -23300:  # array attr: "count,v0,v1,..."
                parts = v.split(",")
                vals = [_parse_value(p) for p in parts[1:]]
                if len(vals) != int(parts[0]):
                    raise ValueError(f"{name}: array attr {k} count mismatch")
                attrs[-(key + 23300)] = vals
            else:
                attrs[key] = _parse_value(v)
        layers.append(NcnnLayer(ltype, name, bottoms, tops, attrs))
    if len(layers) != layer_count:
        raise ValueError(
            f"param declares {layer_count} layers, found {len(layers)}"
        )
    return layers


class _BinReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, nbytes: int) -> bytes:
        if self.pos + nbytes > len(self.data):
            raise ValueError(
                f".bin truncated: need {nbytes} bytes at {self.pos}, "
                f"file has {len(self.data)}"
            )
        out = self.data[self.pos : self.pos + nbytes]
        self.pos += nbytes
        return out

    def read_raw_fp32(self, count: int) -> np.ndarray:
        return np.frombuffer(self._take(4 * count), dtype="<f4").copy()

    def read_tagged(self, count: int) -> np.ndarray:
        (tag,) = np.frombuffer(self._take(4), dtype="<u4")
        if tag in (_TAG_FP32, _TAG_RAW32):
            return self.read_raw_fp32(count)
        if tag == _TAG_FP16:
            arr = np.frombuffer(self._take(2 * count), dtype="<f2")
            # ncnn aligns the fp16 payload to a 4-byte boundary
            if (2 * count) % 4:
                self._take(2)
            return arr.astype(np.float32)
        if tag == _TAG_INT8:
            raise ValueError("int8 NCNN weights are not supported")
        raise ValueError(f"unknown NCNN weight tag 0x{int(tag):08x}")


def read_ncnn_bin(
    layers: Sequence[NcnnLayer], src: Union[str, bytes]
) -> None:
    """Attach weights to Convolution/MemoryData layers, in declaration
    order (the ``.bin`` is a flat concatenation in that order)."""
    data = src if isinstance(src, bytes) else open(src, "rb").read()
    r = _BinReader(data)
    for layer in layers:
        if layer.type in ("Convolution", "ConvolutionDepthWise"):
            wsize = int(layer.attr(6, 0))
            out_c = int(layer.attr(0))
            kw, kh = int(layer.attr(1, 1)), int(layer.attr(11, layer.attr(1, 1)))
            if layer.type == "ConvolutionDepthWise":
                g = int(layer.attr(7, 1))
                if g != out_c:
                    raise ValueError(
                        f"{layer.name}: grouped conv with groups={g} != "
                        f"out={out_c} — only depthwise supported"
                    )
            w = r.read_tagged(wsize)
            in_c = wsize // (out_c * kw * kh)
            layer.weights["weight"] = w.reshape(out_c, in_c, kh, kw)
            if int(layer.attr(5, 0)):
                layer.weights["bias"] = r.read_raw_fp32(out_c)
        elif layer.type == "InnerProduct":
            out_c = int(layer.attr(0))
            wsize = int(layer.attr(2, 0))
            w = r.read_tagged(wsize)
            layer.weights["weight"] = w.reshape(out_c, wsize // out_c)
            if int(layer.attr(1, 0)):
                layer.weights["bias"] = r.read_raw_fp32(out_c)
        elif layer.type == "MemoryData":
            w = int(layer.attr(0, 0)) or 1
            h = int(layer.attr(1, 0))
            c = int(layer.attr(2, 0))
            count = w * (h or 1) * (c or 1)
            arr = r.read_raw_fp32(count)
            if c:
                arr = arr.reshape(c, h or 1, w)
            elif h:
                arr = arr.reshape(h, w)
            layer.weights["data"] = arr
    if r.pos != len(data):
        raise ValueError(
            f".bin has {len(data) - r.pos} trailing bytes after the last "
            "declared weight blob — wrong param/bin pairing?"
        )


# --------------------------------------------------------------------------- #
# topology verification: pnnx emits convolutions in module execution order
# --------------------------------------------------------------------------- #


def _c2f_plan(idx: int, out_c: int, n: int, hidden: Optional[int] = None):
    """Conv emission order inside a C2f block: cv1, m.*, cv2."""
    h = hidden if hidden is not None else out_c // 2
    plan = [(f"model.{idx}.cv1", out_c, 1)]
    for j in range(n):
        plan += [
            (f"model.{idx}.m.{j}.cv1", h, 3),
            (f"model.{idx}.m.{j}.cv2", h, 3),
        ]
    plan.append((f"model.{idx}.cv2", out_c, 1))
    return plan


def ultralytics_conv_plan(
    cfg: DetectorConfig,
) -> List[Tuple[str, int, int]]:
    """The (module_path, out_channels, kernel) sequence of every conv in a
    yolo_plus export, in pnnx/NCNN declaration order (module execution
    order: backbone model.0-9, neck model.12-21, head model.22 with
    cv2/cv3 interleaved per level, DFL last — model.ncnn.param:3-208)."""
    c = cfg.channels
    d = cfg.depths
    dn3, dn4 = cfg.neck_down_channels
    n_neck = d[0]
    plan: List[Tuple[str, int, int]] = [
        ("model.0", c[0], 3),
        ("model.1", c[1], 3),
        *_c2f_plan(2, c[1], d[0]),
        ("model.3", c[2], 3),
        *_c2f_plan(4, c[2], d[1]),
        ("model.5", c[3], 3),
        *_c2f_plan(6, c[3], d[2]),
        ("model.7", c[4], 3),
        *_c2f_plan(8, c[4], d[3]),
        (f"model.9.cv1", c[4] // 2, 1),  # SPPF
        (f"model.9.cv2", c[4], 1),
        *_c2f_plan(12, c[3], n_neck),
        *_c2f_plan(15, c[2], n_neck),
        ("model.16", dn3, 3),
        *_c2f_plan(18, c[3], n_neck),
        ("model.19", dn4, 3),
        *_c2f_plan(21, c[4], n_neck),
    ]
    for i in range(3):
        plan += [
            (f"model.22.cv2.{i}.0", cfg.reg_channels, 3),
            (f"model.22.cv2.{i}.1", cfg.reg_channels, 3),
            (f"model.22.cv2.{i}.2", 4 * cfg.reg_max, 1),
            (f"model.22.cv3.{i}.0", cfg.cls_channels, 3),
            (f"model.22.cv3.{i}.1", cfg.cls_channels, 3),
            (f"model.22.cv3.{i}.2", cfg.num_classes, 1),
        ]
    plan.append(("model.22.dfl", 1, 1))
    return plan


def _c3_plan(idx: int, out_c: int, n: int) -> List[Tuple[str, int, int]]:
    """v5 C3 emission order: cv1, m.* (1x1+3x3 at FULL hidden width,
    e=1.0), cv2, cv3 — the torch trace evaluates ``m(cv1(x))`` before
    ``cv2(x)`` (yolo5 export: model.ncnn.param conv_4-8)."""
    h = out_c // 2
    plan = [(f"model.{idx}.cv1", h, 1)]
    for j in range(n):
        plan += [
            (f"model.{idx}.m.{j}.cv1", h, 1),
            (f"model.{idx}.m.{j}.cv2", h, 3),
        ]
    plan += [(f"model.{idx}.cv2", h, 1), (f"model.{idx}.cv3", out_c, 1)]
    return plan


def _c3k_plan(path: str, out_c: int) -> List[Tuple[str, int, int]]:
    """v11 C3k emission order: like C3 but the 2 inner bottlenecks are
    half-width 3x3+3x3 pairs (yolo11 export conv_16-22)."""
    h = out_c // 2
    plan = [(f"{path}.cv1", h, 1)]
    for j in range(2):
        plan += [
            (f"{path}.m.{j}.cv1", h, 3),
            (f"{path}.m.{j}.cv2", h, 3),
        ]
    plan += [(f"{path}.cv2", h, 1), (f"{path}.cv3", out_c, 1)]
    return plan


def _c3k2_plan(idx: int, out_c: int, n: int, c3k: bool, e: float = 0.5):
    """v11 C3k2 emission order: cv1, m.* (C3k or half-expansion
    bottlenecks), cv2."""
    hidden = int(out_c * e)
    plan = [(f"model.{idx}.cv1", 2 * hidden, 1)]
    for j in range(n):
        if c3k:
            plan += _c3k_plan(f"model.{idx}.m.{j}", hidden)
        else:
            plan += [
                (f"model.{idx}.m.{j}.cv1", hidden // 2, 3),
                (f"model.{idx}.m.{j}.cv2", hidden, 3),
            ]
    plan.append((f"model.{idx}.cv2", out_c, 1))
    return plan


def yolov5u_conv_plan(num_classes: int = 1):
    """Conv emission order of the deployed yolov5nu export (v5 body, v8
    DFL head at model.24 — src/*/convert/model/yolo5/yolo5_ncnn_model/
    model.ncnn.param, 76 convs)."""
    c = (16, 32, 64, 128, 256)
    d = (1, 2, 3, 1)
    plan: List[Tuple[str, int, int]] = [
        ("model.0", c[0], 6),
        ("model.1", c[1], 3),
        *_c3_plan(2, c[1], d[0]),
        ("model.3", c[2], 3),
        *_c3_plan(4, c[2], d[1]),
        ("model.5", c[3], 3),
        *_c3_plan(6, c[3], d[2]),
        ("model.7", c[4], 3),
        *_c3_plan(8, c[4], d[3]),
        ("model.9.cv1", c[4] // 2, 1),  # SPPF
        ("model.9.cv2", c[4], 1),
        ("model.10", c[3], 1),  # pre-upsample reduce
        *_c3_plan(13, c[3], 1),
        ("model.14", c[2], 1),
        *_c3_plan(17, c[2], 1),
        ("model.18", c[2], 3),
        *_c3_plan(20, c[3], 1),
        ("model.21", c[3], 3),
        *_c3_plan(23, c[4], 1),
    ]
    for i in range(3):
        plan += [
            (f"model.24.cv2.{i}.0", 64, 3),
            (f"model.24.cv2.{i}.1", 64, 3),
            (f"model.24.cv2.{i}.2", 64, 1),
            (f"model.24.cv3.{i}.0", 64, 3),
            (f"model.24.cv3.{i}.1", 64, 3),
            (f"model.24.cv3.{i}.2", num_classes, 1),
        ]
    plan.append(("model.24.dfl", 1, 1))
    return plan


def yolov11n_conv_plan(num_classes: int = 1):
    """Conv emission order of the deployed yolov11n export (C3k2/C2PSA
    body, depthwise-separable cls head at model.23 — src/*/convert/model/
    yolo11/yolo11_ncnn_model/model.ncnn.param, 81 convs + 7 depthwise).

    Entries are (path, out_channels, kernel[, groups]); groups > 1 marks a
    ConvolutionDepthWise layer."""
    c = (16, 32, 64, 128, 256)
    h = c[4] // 2
    plan = [
        ("model.0", c[0], 3),
        ("model.1", c[1], 3),
        *_c3k2_plan(2, c[2], 1, False, 0.25),
        ("model.3", c[2], 3),
        *_c3k2_plan(4, c[3], 1, False, 0.25),
        ("model.5", c[3], 3),
        *_c3k2_plan(6, c[3], 1, True),
        ("model.7", c[4], 3),
        *_c3k2_plan(8, c[4], 1, True),
        ("model.9.cv1", c[4] // 2, 1),  # SPPF
        ("model.9.cv2", c[4], 1),
        # C2PSA: cv1, attn (qkv, matmuls, depthwise pe, proj), ffn, cv2
        ("model.10.cv1", c[4], 1),
        ("model.10.m.0.attn.qkv", 2 * h, 1),
        ("model.10.m.0.attn.pe", h, 3, h),
        ("model.10.m.0.attn.proj", h, 1),
        ("model.10.m.0.ffn.0", c[4], 1),
        ("model.10.m.0.ffn.1", h, 1),
        ("model.10.cv2", c[4], 1),
        *_c3k2_plan(13, c[3], 1, False),
        *_c3k2_plan(16, c[2], 1, False),
        ("model.17", c[2], 3),
        *_c3k2_plan(19, c[3], 1, False),
        ("model.20", c[3], 3),
        *_c3k2_plan(22, c[4], 1, True),
    ]
    for i, cin in enumerate((64, 128, 256)):
        plan += [
            (f"model.23.cv2.{i}.0", 64, 3),
            (f"model.23.cv2.{i}.1", 64, 3),
            (f"model.23.cv2.{i}.2", 64, 1),
            (f"model.23.cv3.{i}.0.0", cin, 3, cin),  # DWConv
            (f"model.23.cv3.{i}.0.1", 64, 1),
            (f"model.23.cv3.{i}.1.0", 64, 3, 64),  # DWConv
            (f"model.23.cv3.{i}.1.1", 64, 1),
            (f"model.23.cv3.{i}.2", num_classes, 1),
        ]
    plan.append(("model.23.dfl", 1, 1))
    return plan


def _verify_conv_plan(
    layers: Sequence[NcnnLayer],
    plan: Sequence[Tuple],
    errors: List[str],
) -> Dict[str, str]:
    """Check every (DepthWise)Convolution against the emission-order plan
    (entries ``(path, out_c, k[, groups])``); returns layer-name -> path."""
    convs = [
        l for l in layers
        if l.type in ("Convolution", "ConvolutionDepthWise")
    ]
    if len(convs) != len(plan):
        errors.append(
            f"conv count: graph has {len(convs)}, config expects {len(plan)}"
        )
    mapping: Dict[str, str] = {}
    for layer, entry in zip(convs, plan):
        path, out_c, k = entry[:3]
        groups = entry[3] if len(entry) > 3 else 1
        got_c, got_k = int(layer.attr(0)), int(layer.attr(1, 1))
        got_g = (
            int(layer.attr(7, 1))
            if layer.type == "ConvolutionDepthWise" else 1
        )
        if (got_c, got_k, got_g) != (out_c, k, groups):
            errors.append(
                f"{layer.name} -> {path}: graph out={got_c} k={got_k} "
                f"g={got_g}, config expects out={out_c} k={k} g={groups}"
            )
        wsize = int(layer.attr(6, 0))
        if wsize * groups % (out_c * k * k) and not errors:
            errors.append(
                f"{layer.name} -> {path}: weight size {wsize} not divisible "
                f"by out*k*k/g={out_c * k * k // groups}"
            )
        mapping[layer.name] = path
    return mapping


def verify_ncnn_topology(
    layers: Sequence[NcnnLayer], cfg: DetectorConfig
) -> Dict[str, str]:
    """Layer-by-layer parity check of ``cfg`` against a parsed graph.

    Checks every Convolution's out-channels/kernel against the canonical
    plan, plus the decode subgraph's structural constants: the anchor-count
    reshapes per level, the ``4*reg_max/nc`` split, and the
    ``reg_max x 4 x A`` DFL reshape (model.ncnn.param:184-193).  Returns
    ``{ncnn_layer_name: ultralytics_module_path}`` for the convs.
    Raises ``ValueError`` with a full mismatch list otherwise.
    """
    errors: List[str] = []
    mapping = _verify_conv_plan(layers, ultralytics_conv_plan(cfg), errors)

    # decode subgraph structure
    A = cfg.num_anchors
    per_level = [
        (cfg.input_size // s) ** 2 for s in cfg.strides
    ]
    _verify_decode(
        layers, cfg.num_classes, cfg.reg_max, A, per_level, errors
    )
    if errors:
        raise ValueError(
            f"NCNN topology does not match config {cfg.name!r}:\n  "
            + "\n  ".join(errors)
        )
    return mapping


def _verify_decode(
    layers: Sequence[NcnnLayer],
    num_classes: int,
    reg_max: int,
    num_anchors: int,
    per_level: Sequence[int],
    errors: List[str],
) -> None:
    """The in-graph decode's structural constants — shared by every
    Ultralytics anchor-free export (yolo_plus / v8 / v5u / v11)."""
    reshapes = [l for l in layers if l.type == "Reshape"]
    level_reshapes = {
        (int(l.attr(0, -1)), int(l.attr(1, -1))) for l in reshapes
    }
    want_box_cls = 4 * reg_max + num_classes
    for npos in per_level:
        if (npos, want_box_cls) not in level_reshapes:
            errors.append(
                f"missing per-level reshape ({want_box_cls}, {npos}) "
                "in the decode subgraph"
            )
    slices = [l for l in layers if l.type == "Slice"]
    split_sizes = {tuple(l.attr(0)) for l in slices if isinstance(l.attr(0), list)}
    if (4 * reg_max, num_classes) not in {
        tuple(int(v) for v in s) for s in split_sizes
    }:
        errors.append(
            f"missing box/class split {4 * reg_max}/{num_classes} "
            f"(found {sorted(split_sizes)})"
        )
    if not any(
        int(l.attr(0, -1)) == num_anchors
        and int(l.attr(1, -1)) == reg_max
        and int(l.attr(2, -1)) == 4
        for l in reshapes
    ):
        errors.append(
            f"missing DFL reshape ({reg_max}, 4, {num_anchors}) "
            "— reg_max parity"
        )


_VARIANT_PLANS = {
    "yolov5nu": (yolov5u_conv_plan, 24),
    "yolov11n": (yolov11n_conv_plan, 23),
}


def variant_state_converter(variant: str):
    """Fused-state-dict -> Flax-variables converter for a baseline
    variant — the single registry shared by the NCNN/OpenVINO/CLI
    ingestion paths (keep in sync with ``_VARIANT_PLANS``)."""
    from litepi_tpu_torch.weights.torch_import import (
        convert_yolov5u_state_dict,
        convert_yolov11_state_dict,
    )

    converters = {
        "yolov5nu": convert_yolov5u_state_dict,
        "yolov11n": convert_yolov11_state_dict,
    }
    if variant not in converters:
        raise ValueError(
            f"unknown variant {variant!r}; choices: {sorted(converters)}"
        )
    return converters[variant]


def verify_ncnn_variant_topology(
    layers: Sequence[NcnnLayer],
    variant: str,
    num_classes: int = 1,
    input_size: int = 640,
) -> Dict[str, str]:
    """Layer-by-layer parity check of a baseline variant ('yolov5nu' /
    'yolov11n') against a parsed graph — same contract as
    :func:`verify_ncnn_topology` but driven by the variant's canonical
    emission plan instead of a yolo_plus DetectorConfig."""
    if variant not in _VARIANT_PLANS:
        raise ValueError(
            f"unknown variant {variant!r}; choices: {sorted(_VARIANT_PLANS)}"
        )
    plan_fn, _head = _VARIANT_PLANS[variant]
    errors: List[str] = []
    mapping = _verify_conv_plan(layers, plan_fn(num_classes), errors)
    per_level = [(input_size // s) ** 2 for s in (8, 16, 32)]
    _verify_decode(
        layers, num_classes, 16, sum(per_level), per_level, errors
    )
    if errors:
        raise ValueError(
            f"NCNN topology does not match variant {variant!r}:\n  "
            + "\n  ".join(errors)
        )
    return mapping


# --------------------------------------------------------------------------- #
# weight conversion
# --------------------------------------------------------------------------- #


def ncnn_state_dict(
    layers: Sequence[NcnnLayer], cfg: DetectorConfig
) -> Dict[str, np.ndarray]:
    """Graph weights -> Ultralytics-style (fused) state dict.

    NCNN convs carry the BN-folded bias exactly like the ONNX export, so
    the names feed :func:`litepi_tpu_torch.weights.onnx_import.defuse_state_dict`.
    The head's final 1x1 convs and the DFL conv are bare ``.weight`` keys
    (no ConvBN wrapper), matching the torch module layout.
    """
    mapping = verify_ncnn_topology(layers, cfg)
    bare = {
        f"model.22.cv{b}.{i}.2" for b in (2, 3) for i in range(3)
    }
    return _weights_to_state_dict(layers, mapping, bare)


def _weights_to_state_dict(
    layers: Sequence[NcnnLayer],
    mapping: Dict[str, str],
    bare: set,
) -> Dict[str, np.ndarray]:
    """Attach graph conv weights to Ultralytics-style keys: ConvBN convs
    get a ``.conv`` stem (BN-folded bias rides along for defusion), the
    ``bare`` module paths (head 1x1s, DFL) keep plain ``.weight``."""
    sd: Dict[str, np.ndarray] = {}
    for layer in layers:
        if layer.type not in ("Convolution", "ConvolutionDepthWise"):
            continue
        path = mapping[layer.name]
        if "weight" not in layer.weights:
            raise ValueError(
                f"{layer.name}: no weights attached — call read_ncnn_bin "
                "first (the tt100k tree ships only the .param text; its "
                ".bin is stripped per .MISSING_LARGE_BLOBS)"
            )
        stem = path if path in bare else f"{path}.conv"
        sd[f"{stem}.weight"] = layer.weights["weight"]
        if "bias" in layer.weights:
            sd[f"{stem}.bias"] = layer.weights["bias"]
    return sd


def ncnn_variant_state_dict(
    layers: Sequence[NcnnLayer], variant: str, num_classes: int = 1
) -> Dict[str, np.ndarray]:
    """Baseline-variant graph weights -> Ultralytics-style (fused) state
    dict, keyed by the emission plan of :func:`yolov5u_conv_plan` /
    :func:`yolov11n_conv_plan`."""
    mapping = verify_ncnn_variant_topology(layers, variant, num_classes)
    _plan_fn, head = _VARIANT_PLANS[variant]
    bare = {f"model.{head}.cv{b}.{i}.2" for b in (2, 3) for i in range(3)}
    return _weights_to_state_dict(layers, mapping, bare)


def convert_detector_ncnn_variant(
    param_path: str,
    bin_path: str,
    variant: str,
    num_classes: int = 1,
):
    """NCNN baseline export -> Flax variables for YoloV5(anchor_free=True)
    or YoloV11 (reference deploys both alongside yolo_plus —
    src/*/convert/model/{yolo5,yolo11}/)."""
    from litepi_tpu_torch.weights.onnx_import import defuse_state_dict

    layers = (
        param_path if isinstance(param_path, (list, tuple))
        else parse_ncnn_param(param_path)
    )
    read_ncnn_bin(layers, bin_path)
    sd = defuse_state_dict(
        ncnn_variant_state_dict(layers, variant, num_classes)
    )
    return variant_state_converter(variant)(sd)


def convert_detector_ncnn(
    param_path,
    bin_path: str,
    cfg: Optional[DetectorConfig] = None,
):
    """NCNN export -> (YoloLitePi variables, matched config).

    ``param_path`` is a path/text or an already-parsed layer list (the
    e2e CLI probes topology first and passes its parse along).  With
    ``cfg=None`` the variant is inferred from the graph topology
    (model.ncnn.param:2 ``conv_2 0=8`` -> v1, ``0=16`` -> v2; the
    stock-v8n export shares the emission plan at v8n widths)."""
    from litepi_tpu_torch.weights.onnx_import import defuse_state_dict
    from litepi_tpu_torch.weights.torch_import import convert_detector_state_dict

    layers = (
        param_path if isinstance(param_path, (list, tuple))
        else parse_ncnn_param(param_path)
    )
    if cfg is None:
        cfg = infer_detector_config(layers)
    read_ncnn_bin(layers, bin_path)
    sd = defuse_state_dict(ncnn_state_dict(layers, cfg))
    return convert_detector_state_dict(sd, cfg.depths), cfg


def infer_detector_config(
    layers: Sequence[NcnnLayer], input_size: int = 640
) -> DetectorConfig:
    """Pick the config whose topology matches the graph: yolo_plus v2/v1
    or the stock yolov8n baseline (src/*/convert/model/yolo8 — same
    emission plan, v8n widths).  ``input_size`` sizes the decode subgraph's
    anchor-count constants — graphs emitted at a non-640 deployment
    resolution (apps/convert.py --emit_input_size) verify against the same
    family at that resolution."""
    import dataclasses

    from litepi_tpu_torch.core.types import YOLO_PLUS_V1, YOLO_PLUS_V2, YOLOV8N

    errs = []
    for cfg in (YOLO_PLUS_V2, YOLO_PLUS_V1, YOLOV8N):
        cfg = dataclasses.replace(cfg, input_size=input_size)
        try:
            verify_ncnn_topology(layers, cfg)
            return cfg
        except ValueError as e:
            errs.append(str(e).splitlines()[0])
    raise ValueError(
        "graph matches no yolo_plus/yolov8n config "
        f"at input_size {input_size}: " + "; ".join(errs)
    )


# --------------------------------------------------------------------------- #
# classifier graph ingestion (ShuffleNetV2 canonical form)
# --------------------------------------------------------------------------- #


def shufflenet_weighted_plan(stage_repeats=(4, 8, 4)):
    """Declaration-order ``(torch_key, flax_path, layer_type)`` of every
    weighted layer in the canonical ShuffleNetV2 NCNN graph — the form
    the JAX package's ``weights/ncnn_export.py`` emits, matching torchvision's
    module execution order (the reference's pnnx classifier exports,
    convert-model-classify.ipynb cell 8, share it; none survive upstream
    to diff against)."""
    plan = [("conv1.0", ("conv1", "conv"), "Convolution")]
    for s, reps in zip((2, 3, 4), stage_repeats):
        for i in range(reps):
            f, t = f"stage{s}_{i}", f"stage{s}.{i}"
            if i == 0:
                plan += [
                    (f"{t}.branch1.0", (f, "b1_dw", "conv"),
                     "ConvolutionDepthWise"),
                    (f"{t}.branch1.2", (f, "b1_pw", "conv"), "Convolution"),
                ]
            plan += [
                (f"{t}.branch2.0", (f, "b2_pw1", "conv"), "Convolution"),
                (f"{t}.branch2.3", (f, "b2_dw", "conv"),
                 "ConvolutionDepthWise"),
                (f"{t}.branch2.5", (f, "b2_pw2", "conv"), "Convolution"),
            ]
    plan += [
        ("conv5.0", ("conv5", "conv"), "Convolution"),
        ("fc", ("fc",), "InnerProduct"),
    ]
    return plan


def convert_classifier_ncnn(param_path, bin_path):
    """ShuffleNetV2 NCNN pair -> (deploy-form Flax variables, num_classes).

    The graph's weighted-layer sequence must match the canonical plan
    (type-checked layer by layer); weights land as biased convs — the
    ``ShuffleNetV2(fused=True)`` form, which the pipeline's
    ``fold_pipeline_vars`` recognises as already deploy-form.  Closes the
    classifier round trip: ``--emit ncnn`` output loads back here.
    """
    layers = (
        param_path if isinstance(param_path, (list, tuple))
        else parse_ncnn_param(param_path)
    )
    weighted = [
        l for l in layers
        if l.type in ("Convolution", "ConvolutionDepthWise", "InnerProduct")
    ]
    plan = shufflenet_weighted_plan()
    errors: List[str] = []
    if len(weighted) != len(plan):
        errors.append(
            f"weighted-layer count: graph has {len(weighted)}, the "
            f"canonical ShuffleNetV2 form has {len(plan)}"
        )
    for layer, (tkey, _fpath, ltype) in zip(weighted, plan):
        if layer.type != ltype:
            errors.append(f"{layer.name} -> {tkey}: {layer.type} != {ltype}")
    if errors:
        raise ValueError(
            "NCNN graph does not match the canonical ShuffleNetV2 "
            "emission:\n  " + "\n  ".join(errors)
        )
    read_ncnn_bin(layers, bin_path)
    sd: Dict[str, np.ndarray] = {}
    for layer, (tkey, _fpath, _ltype) in zip(weighted, plan):
        sd[f"{tkey}.weight"] = layer.weights["weight"]
        if "bias" in layer.weights:
            sd[f"{tkey}.bias"] = layer.weights["bias"]
    return shufflenet_deploy_variables(sd)


def shufflenet_deploy_variables(sd: Dict[str, np.ndarray]):
    """Fused torchvision-keyed arrays (``conv1.0.weight`` …, ``fc.weight``)
    -> (``ShuffleNetV2(fused=True)`` deploy-form variables, num_classes).
    The shared tail of every classifier ingestion path (NCNN pairs, fused
    ONNX exports) — torch (O, I, kh, kw) kernels transpose to Flax
    (kh, kw, I, O), the fc matrix to (I, O)."""
    params: Dict = {}

    def _set(path, key, value):
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node.setdefault(path[-1], {})[key] = np.ascontiguousarray(value)

    num_classes = None
    for tkey, fpath, ltype in shufflenet_weighted_plan():
        w = sd[f"{tkey}.weight"]
        bias = sd.get(f"{tkey}.bias")
        if ltype == "InnerProduct":
            num_classes = int(w.shape[0])
            _set(fpath, "kernel", w.T.astype(np.float32))
        else:
            _set(fpath, "kernel", np.transpose(w, (2, 3, 1, 0)))
        if bias is not None:
            _set(fpath, "bias", bias)
    return {"params": params}, num_classes


def run_ncnn_graph(
    layers: Sequence[NcnnLayer],
    image_chw: np.ndarray,
    return_blobs: bool = False,
    device="cuda",
):
    """Execute the graph on one (3, H, W) float input, returning ``out0``
    as numpy (with ``return_blobs``, every blob as numpy, by name).

    The op set of the detector exports (yolo_plus, yolov5nu, yolov11n) and
    the ShuffleNetV2 classifier emission: conv/dwconv, swish, relu, slice,
    concat, binaryop, pooling including global, interp, reshape, permute,
    softmax, sigmoid, matmul, shufflechannel and innerproduct, with NCNN's
    blob conventions (3D = (c, h, w), 2D = (h, w), 1D = (w,), no batch
    dim).  Every op runs as torch ops on ``device`` (default the card; it
    raises without one), float32 with TF32 off; the convolutions through
    ``F.conv2d``.  The JAX package's ``run_ncnn_graph`` computes the same
    with XLA convolutions and numpy.
    """
    dev = resolve_device(device)
    blobs: Dict[str, torch.Tensor] = {}
    out_name = layers[-1].tops[0] if layers else "out0"
    with gops.float32_exact():
        for layer in layers:
            t = layer.type
            ins = [blobs[b] for b in layer.bottoms]
            top = layer.tops[0] if layer.tops else None
            if t == "Input":
                blobs[top] = gops.tensor(np.asarray(image_chw, np.float32), dev)
            elif t == "MemoryData":
                blobs[top] = gops.tensor(layer.weights["data"], dev)
            elif t in ("Convolution", "ConvolutionDepthWise"):
                (x,) = ins
                sw, sh = int(layer.attr(3, 1)), int(layer.attr(13, layer.attr(3, 1)))
                dw, dh = int(layer.attr(2, 1)), int(layer.attr(12, layer.attr(2, 1)))
                pl = int(layer.attr(4, 0))
                pr = int(layer.attr(15, pl))
                pt = int(layer.attr(14, pl))
                pb = int(layer.attr(16, pt))
                g = int(layer.attr(7, 1)) if t == "ConvolutionDepthWise" else 1
                w = gops.tensor(layer.weights["weight"], dev)
                y = gops.conv2d(x[None], w, (sh, sw), ((pt, pb), (pl, pr)), (dh, dw), g)[0]
                if "bias" in layer.weights:
                    y = y + gops.tensor(layer.weights["bias"], dev)[:, None, None]
                blobs[top] = y
            elif t == "Swish":
                blobs[top] = gops.swish(ins[0])
            elif t == "Sigmoid":
                blobs[top] = gops.sigmoid(ins[0])
            elif t == "Split":
                for name in layer.tops:
                    blobs[name] = ins[0]
            elif t == "Slice":
                (x,) = ins
                sizes = [int(v) for v in layer.attr(0)]
                axis = int(layer.attr(1, 0))
                fill = [s for s in sizes if s != -233]
                auto = len(sizes) - len(fill)
                if auto:
                    rem = x.shape[axis] - sum(fill)
                    sizes = [rem // auto if s == -233 else s for s in sizes]
                for name, piece in zip(layer.tops, gops.split(x, axis, sizes)):
                    blobs[name] = piece
            elif t == "Concat":
                blobs[top] = torch.cat(ins, dim=int(layer.attr(0, 0)))
            elif t == "BinaryOp":
                op = int(layer.attr(0, 0))
                if int(layer.attr(1, 0)):  # with scalar
                    a, b = ins[0], float(layer.attr(2, 0.0))
                else:
                    a, b = ins
                fn = {0: torch.add, 1: torch.sub, 2: torch.mul, 3: torch.div}.get(op)
                if fn is None:
                    raise ValueError(f"{layer.name}: BinaryOp {op} unsupported")
                blobs[top] = fn(a, b)
            elif t == "Pooling":
                (x,) = ins
                ptype = int(layer.attr(0, 0))
                if ptype not in (0, 1):
                    raise ValueError(f"{layer.name}: Pooling type {ptype} unsupported")
                if int(layer.attr(4, 0)):  # global: reduce the full map
                    blobs[top] = x.amax(dim=(1, 2)) if ptype == 0 else x.mean(dim=(1, 2))
                    out_name = top
                    continue
                if ptype != 0:
                    raise ValueError(f"{layer.name}: windowed avg pooling unsupported")
                kw, kh = int(layer.attr(1, 1)), int(layer.attr(11, layer.attr(1, 1)))
                sw, sh = int(layer.attr(2, 1)), int(layer.attr(12, layer.attr(2, 1)))
                pl = int(layer.attr(3, 0))
                pt = int(layer.attr(13, pl))
                pr = int(layer.attr(14, pl))
                pb = int(layer.attr(15, pt))
                # pad-mode 1 = valid/floor, the only mode the SPPF poolings use
                mode = int(layer.attr(5, 0))
                if mode != 1:
                    raise ValueError(
                        f"{layer.name}: Pooling pad-mode {mode} unsupported "
                        "(only 1 = valid/floor)"
                    )
                blobs[top] = gops.max_pool(x, (kh, kw), (sh, sw), ((pt, pb), (pl, pr)))
            elif t == "ReLU":
                blobs[top] = torch.clamp_min(ins[0], 0.0)
            elif t == "ShuffleChannel":
                (x,) = ins
                g = int(layer.attr(0, 1))
                c = x.shape[0]
                blobs[top] = (x.reshape(g, c // g, *x.shape[1:]).transpose(0, 1)
                              .reshape(x.shape).contiguous())
            elif t == "InnerProduct":
                (x,) = ins
                y = gops.tensor(layer.weights["weight"], dev) @ x.reshape(-1)
                if "bias" in layer.weights:
                    y = y + gops.tensor(layer.weights["bias"], dev)
                blobs[top] = y
            elif t == "Interp":
                (x,) = ins
                if int(layer.attr(0, 0)) != 1:
                    raise ValueError(f"{layer.name}: only nearest Interp")
                fh, fw = float(layer.attr(1, 1.0)), float(layer.attr(2, 1.0))
                blobs[top] = gops.repeat_nearest(x, ((1, int(fh)), (2, int(fw))))
            elif t == "Reshape":
                (x,) = ins
                w = int(layer.attr(0, -233))
                h = int(layer.attr(1, -233))
                c = int(layer.attr(2, -233))
                # rank = highest dim attr present; ncnn shape (c, h, w)
                shape = [c, h, w] if c != -233 else [h, w] if h != -233 else [w]
                blobs[top] = x.reshape([(-1 if d == -233 else d) for d in shape])
            elif t == "Permute":
                (x,) = ins
                order = int(layer.attr(0, 0))
                if x.dim() == 3:
                    # ncnn order_type in (w, h, c) notation; for (c, h, w)
                    # tensors: 1 swaps h/w, 2 swaps c/h, 5 reverses
                    axes = {0: (0, 1, 2), 1: (0, 2, 1), 2: (1, 0, 2),
                            3: (1, 2, 0), 4: (2, 0, 1), 5: (2, 1, 0)}[order]
                    blobs[top] = x.permute(axes)
                elif x.dim() == 2:
                    blobs[top] = x.T if order == 1 else x
                else:
                    blobs[top] = x
            elif t == "Softmax":
                blobs[top] = gops.softmax(ins[0], int(layer.attr(0, 0)))
            elif t == "MatMul":
                a, b2 = ins
                if int(layer.attr(0, 0)):  # transB
                    b2 = b2.transpose(-1, -2)
                blobs[top] = torch.matmul(a, b2)
            else:
                raise ValueError(f"unsupported NCNN layer type {t!r}")
            out_name = top
    if return_blobs:
        return {k: gops.to_numpy(v) for k, v in blobs.items()}
    return gops.to_numpy(blobs.get("out0", blobs[out_name]))
