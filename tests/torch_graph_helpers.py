"""Helpers of the graph emitter and interpreter tests of the port
(tests/test_torch_export_*.py, tests/test_torch_convert_cli.py) and of
chip_smoke.py's convert phase.

The families the emitters cover, their seeded Flax-named trees (made
without JAX), one emission helper that drives either package's emitter
modules through their common API (the JAX package's imported only there,
so chip_smoke.py can load this module on a machine without JAX), and the
port's model plus decode in the detector graphs' output form.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

import numpy as np

PLUS = ("yolo_plus_v2", "yolo_plus_v1", "yolov8n")
VARIANTS = ("yolov5nu", "yolov11n")
DETECTORS = PLUS + VARIANTS
CLASSIFIER = "shufflenetv2"
CLS_CLASSES = 91
# the families each format's emitter covers
FORMAT_FAMILIES = {
    "ncnn": DETECTORS + (CLASSIFIER,),
    "onnx": PLUS + (CLASSIFIER,),
    "openvino": DETECTORS + (CLASSIFIER,),
}


def plus_config(types_module, family: str, input_size: int = 640):
    """The yolo_plus-family DetectorConfig of ``types_module`` (the JAX or
    the port's ``core/types.py``) at ``input_size``."""
    cfg = {"yolo_plus_v2": types_module.YOLO_PLUS_V2, "yolo_plus_v1": types_module.YOLO_PLUS_V1,
           "yolov8n": types_module.YOLOV8N}[family]
    return dataclasses.replace(cfg, input_size=input_size)


def _port_module(family: str):
    """The port's module of ``family`` (BatchNorm unfused)."""
    from litepi_tpu_torch.core import types
    from litepi_tpu_torch.models import YoloLitePi, YoloV5, YoloV11, build_classifier

    if family in PLUS:
        return YoloLitePi(plus_config(types, family))
    if family == "yolov5nu":
        return YoloV5(num_classes=1, anchor_free=True)
    if family == "yolov11n":
        return YoloV11(num_classes=1)
    return build_classifier(CLASSIFIER, CLS_CLASSES)


def family_vars(family: str, seed: int = 0) -> Dict:
    """Seeded numpy variables (BatchNorm unfused) in the Flax layout of the
    family's JAX model, valued as tests/torch_port_helpers.py's
    ``random_jax_vars`` values them, without tracing the JAX model: the
    shapes come from the port's module, whose parameters carry the Flax
    names (``weights/jax_bridge.py`` maps a Flax tree onto them leaf for
    leaf, HWIO -> OIHW, Dense transposed, and the model tests load the JAX
    models' variables into them strictly)."""
    rng = np.random.default_rng(seed)
    tree: Dict = {"params": {}, "batch_stats": {}}
    for key, t in _port_module(family).state_dict().items():
        *path, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        shape = tuple(t.shape)
        coll = "batch_stats" if leaf.startswith("running_") else "params"
        if leaf == "running_mean":
            name, a = "mean", rng.normal(0, 0.1, shape)
        elif leaf == "running_var":
            name, a = "var", rng.uniform(0.5, 1.5, shape)
        elif leaf == "weight" and t.dim() == 1:  # a BatchNorm scale
            name, a = "scale", rng.uniform(0.8, 1.2, shape)
        elif leaf == "weight":  # OIHW -> HWIO, Linear (out, in) -> Dense (in, out)
            shape = (*shape[2:], shape[1], shape[0]) if t.dim() == 4 else shape[::-1]
            name = "kernel"
            a = rng.normal(0, 1 / np.sqrt(int(np.prod(shape[:-1])) or 1), shape)
        else:
            name, a = "bias", rng.normal(0, 0.1, shape)
        node = tree[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[name] = a.astype(np.float32)
    return tree


def emit(pkg: Dict, fmt: str, family: str, variables: Dict, out_dir: str,
         dtype: str = "fp32", size: int = 640) -> Dict[str, str]:
    """Write ``family``'s graph in ``fmt`` through ``pkg`` (``{"types",
    "ncnn", "onnx", "openvino"}``: the modules of one package) into
    ``out_dir``; returns the written paths by extension.  ``size`` is the
    detector's baked input size, the classifier's input size."""
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.join(out_dir, f"{family}_{fmt}_{dtype}")
    mod = pkg[fmt]
    if fmt == "ncnn":
        paths = {"param": base + ".param", "bin": base + ".bin"}
        if family == CLASSIFIER:
            mod.export_classifier_ncnn(family, variables, CLS_CLASSES, paths["param"],
                                       paths["bin"], dtype=dtype)
        elif family in PLUS:
            mod.export_detector_ncnn(variables, plus_config(pkg["types"], family, size),
                                     paths["param"], paths["bin"], dtype=dtype)
        else:
            mod.export_detector_ncnn_variant(variables, family, paths["param"], paths["bin"],
                                             dtype=dtype, input_size=size)
    elif fmt == "onnx":
        paths = {"onnx": base + ".onnx"}
        if family == CLASSIFIER:
            mod.export_classifier_onnx(family, variables, CLS_CLASSES, paths["onnx"],
                                       input_size=size)
        else:
            mod.export_detector_onnx(variables, plus_config(pkg["types"], family, size),
                                     paths["onnx"])
    else:
        paths = {"xml": base + ".xml", "bin": base + ".bin"}
        if family == CLASSIFIER:
            mod.export_classifier_openvino(family, variables, CLS_CLASSES, paths["xml"],
                                           paths["bin"], input_size=size)
        elif family in PLUS:
            mod.export_detector_openvino(variables, plus_config(pkg["types"], family, size),
                                         paths["xml"], paths["bin"])
        else:
            mod.export_detector_openvino_variant(variables, family, paths["xml"], paths["bin"],
                                                 input_size=size)
    return paths


def port_package() -> Dict:
    from litepi_tpu_torch.core import types
    from litepi_tpu_torch.weights import ncnn_export, onnx_export, openvino_export

    return {"types": types, "ncnn": ncnn_export, "onnx": onnx_export, "openvino": openvino_export}


def jax_package() -> Dict:
    from litepi_tpu.core import types
    from litepi_tpu.weights import ncnn_export, onnx_export, openvino_export

    return {"types": types, "ncnn": ncnn_export, "onnx": onnx_export, "openvino": openvino_export}


def port_model(family: str, variables: Dict, device="cpu"):
    """The port's module of ``family`` with ``variables`` loaded, float32,
    in eval mode on ``device``."""
    from litepi_tpu_torch.weights.jax_bridge import jax_to_state_dict

    model = _port_module(family)
    model.load_state_dict(jax_to_state_dict(variables))
    return model.eval().to(device)


def port_graph_output(model, image_chw: np.ndarray, detector: bool = True) -> np.ndarray:
    """What an emitted graph computes, from the port's model on
    ``image_chw`` (3, S, S): a detector's (5, A) rows (x, y, w, h in input
    pixels from the DFL decode, then the class score), a classifier's
    (num_classes,) logits.  float32, TF32 off, on the model's device."""
    import torch

    from litepi_tpu_torch.ops.anchors import make_anchors
    from litepi_tpu_torch.ops.dfl import decode_boxes, dfl_decode
    from litepi_tpu_torch.weights.graph_ops import float32_exact

    dev = next(model.parameters()).device
    x = torch.from_numpy(np.ascontiguousarray(image_chw, np.float32))[None].to(dev)
    with float32_exact():
        out = model(x)
        if not detector:
            return out[0].cpu().numpy()
        pts, strides = (torch.from_numpy(a).to(dev) for a in make_anchors(image_chw.shape[-1]))
        boxes = decode_boxes(dfl_decode(out["reg"], 16), pts, strides, xywh=True)
        cls = torch.sigmoid(out["cls"].float())
        return torch.cat([boxes[0].T, cls[0].T], dim=0).cpu().numpy()


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| relative to the largest magnitude of ``want``."""
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))
