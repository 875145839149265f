"""End-to-end evaluation CLI of the PyTorch port, flag-compatible with the
JAX package's ``apps/e2e.py`` and the reference ``e2e.py`` (reference:
src/tt100k/pipeline/e2e.py:1013-1189).

It evaluates the artifacts the reference deploys on the port's pipeline,
on the card by default (``--device cuda``; there is no fallback: without a
card it raises) or on the CPU with ``--device cpu``:

* ``--detector_param model.ncnn.param --detector_bin model.ncnn.bin`` —
  an NCNN pair; the architecture (yolo_plus v1/v2, yolov8n, yolov5nu,
  yolov11n) is inferred from the graph topology;
* ``--detector foo.xml`` — an OpenVINO IR (+ sibling ``.bin`` or
  ``--detector_bin``), the same topology probe;
* ``--detector foo.onnx`` — an ONNX export;
* ``--detector best.pt`` — an Ultralytics training container (or a
  ``.pth`` state dict);
* ``--detector ckpt_dir`` — a checkpoint of the port
  (``weights/checkpoint.py``); an orbax directory (the JAX package's
  format) is refused with rc 2;
* no ``--detector`` (or ``random``) — seeded random weights
  (``weights/seeded.py``), with a warning.

The classifier loads from a torchvision ``.pth``, an NCNN ``.param`` (+
sibling ``.bin``), an ONNX export, an OpenVINO ``.xml`` (+ sibling
``.bin``) or a port checkpoint; without ``--classifier`` it takes seeded
random weights.  Every importer returns Flax-named numpy variables, which
reach the pipeline through ``weights/jax_bridge.py``.

It writes what the JAX CLI writes, through the port's ``write_results``:
``comparison_summary.csv`` (appended), the per-combo results CSV, the
test-files manifest, and ``viz/`` with ``--save_viz``.

Usage:
    python -m litepi_tpu_torch.apps.e2e \\
        --detector_param model.ncnn.param --detector_bin model.ncnn.bin \\
        --classifier shufflenetv2.pth --input data/images \\
        --labels data/labels --classes idx2label.json --output output_eval
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys
from typing import Optional

import torch

# --matmul_precision for a float32 pipeline on the card.  JAX's "high"
# (bf16_3x passes on a TPU) maps to torch's "high": float32 matmuls and
# cuDNN convs may use TF32.  "default" and "highest" keep TF32 off, the
# port's precision contract for float32.  The pipeline sets the flags
# around its own calls (TwoStagePipeline.precision); a bf16 pipeline's
# calls run under the caller's.
MATMUL_TF32 = {None: False, "default": False, "high": True, "highest": False}

# the --detector_variant names of the zoo detectors and their names in the
# NCNN / OpenVINO baseline plans
ZOO_ARTIFACT_NAMES = {"yolov5n": "yolov5nu", "yolov11n": "yolov11n"}


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Two-stage TSR e2e evaluation (PyTorch port)")
    # weights
    p.add_argument(
        "--detector", default=None,
        help="port checkpoint dir, .onnx/.pt export, OpenVINO .xml, or 'random'",
    )
    p.add_argument(
        "--detector_param", default=None, help="NCNN .param graph (with --detector_bin)",
    )
    p.add_argument(
        "--detector_bin", default=None,
        help="NCNN .bin weights; also the OpenVINO .bin when --detector "
        "is an .xml whose sibling .bin is elsewhere",
    )
    p.add_argument(
        "--detector_variant",
        default=None,  # resolved from --dataset preset when omitted
        choices=["yolo_plus_v2", "yolo_plus_v1", "yolov8n", "yolov11n",
                 "yolov5n", "yolov5n_legacy"],
    )
    # dataset preset: class count, shipped detector, classifier crop stats
    p.add_argument("--dataset", default="tt100k", choices=["tt100k", "vntsr"])
    p.add_argument(
        "--cls_mean", type=float, nargs="+", default=None,
        help="classifier crop normalisation mean (1 or 3 floats)",
    )
    p.add_argument(
        "--cls_std", type=float, nargs="+", default=None,
        help="classifier crop normalisation std (1 or 3 floats)",
    )
    p.add_argument(
        "--classifier", default=None,
        help="port checkpoint dir, torch .pth, NCNN .param (+ sibling .bin), "
        "classifier .onnx, or OpenVINO .xml (+ sibling .bin)",
    )
    p.add_argument(
        "--clf_arch", default="shufflenetv2",
        choices=["resnet18", "efficientnet", "mobilenetv2", "shufflenetv2"],
    )
    p.add_argument("--num_classes", type=int, default=None)
    # data
    p.add_argument("--input", required=True, help="image directory")
    p.add_argument("--labels", required=True, help="YOLO label directory")
    p.add_argument("--classes", default=None, help="idx2label.json or names txt")
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    # thresholds (reference defaults, e2e.py:1014-1050)
    p.add_argument("--yolo_conf", type=float, default=0.001)
    p.add_argument("--benchmark_conf", type=float, default=0.25)
    p.add_argument("--min_area", type=float, default=50.0)
    p.add_argument("--iou_threshold", type=float, default=0.45)
    p.add_argument("--det_input_size", type=int, default=640)
    p.add_argument("--cls_input_size", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_det", type=int, default=64)
    p.add_argument("--max_candidates", type=int, default=512)
    # mAP-pass budgets; 0 = unbounded, the reference's low-conf protocol
    p.add_argument("--eval_max_det", type=int, default=0)
    p.add_argument("--eval_max_candidates", type=int, default=0)
    # accepted for compatibility with the reference's scripts; no effect
    p.add_argument("--detector_threads", type=int, default=4, help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument(
        "--roi_impl", default="dense", choices=["dense", "windowed", "pallas"],
        help="fused-path ROI crop: dense, pallas (the pyramid crop) or "
        "windowed (the JAX package's windowed crop; the dense one on small frames)",
    )
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument(
        "--matmul_precision", default=None, choices=["default", "high", "highest"],
        help="float32 on the card: 'high' allows TF32; the others keep it off",
    )
    p.add_argument(
        "--metrics", default="reference", choices=["reference", "ultralytics", "level0"],
        help="level0 = the simple single-IoU greedy surface of the level-0 "
        "baseline (no mAP columns)",
    )
    # output
    p.add_argument("--output", default="output_eval")
    p.add_argument("--save_viz", action="store_true")
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--no_jit", action="store_true", help=argparse.SUPPRESS)
    return p


def _error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def apply_matmul_precision(precision: Optional[str], dtype: torch.dtype) -> bool:
    """Whether a float32 pipeline allows TF32 under ``--matmul_precision``
    (:data:`MATMUL_TF32`): the pipeline's ``allow_tf32``, which it sets
    around its own calls only (``TwoStagePipeline.precision``; the flags
    act on the card), never for the process.  False for a bf16 pipeline."""
    return dtype == torch.float32 and MATMUL_TF32[precision]


def _probe_ncnn(args, sizes):
    """(layers, yolo_plus config or None, variant) of ``--detector_param``'s
    graph, or an rc-2 message."""
    from litepi_tpu_torch.weights.ncnn_import import (
        infer_detector_config,
        parse_ncnn_param,
        verify_ncnn_variant_topology,
    )

    try:
        layers = parse_ncnn_param(args.detector_param)
    except (OSError, ValueError) as e:
        return f"--detector_param: {e}"
    # the graph's decode constants are fixed at emission resolution: try
    # the CLI's size first, then the reference's canonical 640
    err = None
    for sz in sizes:
        try:
            cfg = infer_detector_config(layers, sz)
            return layers, cfg, cfg.name
        except ValueError as e:
            err = e
    for cli_name, plan in ZOO_ARTIFACT_NAMES.items():
        for sz in sizes:
            try:
                verify_ncnn_variant_topology(layers, plan, input_size=sz)
                return layers, None, cli_name
            except ValueError:
                continue
    return f"--detector_param: {err}"


def _probe_openvino(args):
    """(graph, yolo_plus config or None, variant) of ``--detector``'s IR,
    or an rc-2 message."""
    from litepi_tpu_torch.core.types import YOLO_PLUS_V1, YOLO_PLUS_V2, YOLOV8N
    from litepi_tpu_torch.weights.openvino_import import (
        parse_openvino_xml,
        verify_openvino_topology,
        verify_openvino_variant_topology,
    )

    try:
        graph = parse_openvino_xml(args.detector)
    # SyntaxError covers xml.etree's ParseError on malformed IRs
    except (OSError, SyntaxError, ValueError) as e:
        return f"--detector: {e}"
    for cand in (YOLO_PLUS_V2, YOLO_PLUS_V1, YOLOV8N):
        try:
            verify_openvino_topology(args.detector, cand, graph=graph)
            return graph, cand, cand.name
        except ValueError:
            continue
    for cli_name, plan in ZOO_ARTIFACT_NAMES.items():
        try:
            verify_openvino_variant_topology(args.detector, plan, graph=graph)
            return graph, None, cli_name
        except ValueError:
            continue
    return (f"{args.detector} matches no deployed detector topology "
            "(yolo_plus v1/v2, yolov8n, yolov5nu, yolov11n)")


def _load_detector(args, cfg, probe):
    """Flax-named detector variables from the artifact ``args`` name, None
    for seeded random weights, or an rc-2 message."""
    from litepi_tpu_torch.weights.checkpoint import load_checkpoint

    det = args.detector or ""
    zoo = args.detector_variant in ("yolov5n", "yolov5n_legacy", "yolov11n")
    if det.endswith((".onnx", ".pt", ".pth")) and zoo:
        return ("direct v5n/v11n artifact loading covers NCNN .param pairs and "
                "OpenVINO .xml IRs; convert other formats to a checkpoint first")
    plan = ZOO_ARTIFACT_NAMES.get(args.detector_variant)
    if args.detector_param:
        from litepi_tpu_torch.weights import ncnn_import as nc

        layers, inferred_cfg = probe[0], probe[1]
        try:
            if plan:
                return nc.convert_detector_ncnn_variant(
                    layers, args.detector_bin, plan, cfg.detector.num_classes)
            return nc.convert_detector_ncnn(layers, args.detector_bin, inferred_cfg)[0]
        except (OSError, ValueError) as e:
            return f"--detector_bin: {e}"
    if det.endswith(".xml"):
        from litepi_tpu_torch.weights import openvino_import as ov

        graph, inferred_cfg = probe[0], probe[1]
        ov_bin = args.detector_bin or det[: -len(".xml")] + ".bin"
        try:
            if plan:
                return ov.convert_detector_openvino_variant(
                    det, ov_bin, plan, cfg.detector.num_classes, graph=graph)
            return ov.convert_detector_openvino(det, ov_bin, inferred_cfg, graph=graph)[0]
        except (OSError, ValueError) as e:
            return f"--detector: {e}"
    if det.endswith(".onnx"):
        from litepi_tpu_torch.weights.onnx_import import convert_detector_onnx

        try:
            return convert_detector_onnx(det, cfg.detector.depths)
        except (OSError, ValueError, KeyError) as e:
            return f"--detector: {e}"
    if det.endswith((".pt", ".pth")):
        from litepi_tpu_torch.weights.onnx_import import defuse_state_dict
        from litepi_tpu_torch.weights.torch_import import (
            convert_detector_state_dict,
            load_torch_state_dict,
        )

        try:
            return convert_detector_state_dict(
                defuse_state_dict(load_torch_state_dict(det)), cfg.detector.depths)
        except (OSError, ValueError, KeyError, pickle.UnpicklingError) as e:
            return f"--detector: {e}"
    if det and det != "random":
        try:
            return load_checkpoint(det)
        except ValueError as e:
            return f"--detector: {e}"
    return None


def _load_classifier(args):
    """(Flax-named classifier variables or None for seeded random weights,
    the artifact's class count or None), or an rc-2 message."""
    from litepi_tpu_torch.weights.checkpoint import load_checkpoint

    clf = args.classifier
    if not clf:
        return None, None
    if clf.endswith((".pth", ".pt")):
        from litepi_tpu_torch.weights.torch_import import (
            convert_classifier_state_dict,
            load_torch_state_dict,
        )

        return convert_classifier_state_dict(args.clf_arch, load_torch_state_dict(clf)), None
    if clf.endswith((".param", ".xml")) and args.clf_arch != "shufflenetv2":
        return (f"--classifier {os.path.splitext(clf)[1]} covers shufflenetv2 (the "
                "deployed classifier); convert other archs from .pth")
    if clf.endswith(".param"):
        # an NCNN classifier pair in the canonical ShuffleNetV2 form
        from litepi_tpu_torch.weights.ncnn_import import convert_classifier_ncnn

        try:
            return convert_classifier_ncnn(clf, clf[: -len(".param")] + ".bin")
        except (OSError, ValueError) as e:
            return f"--classifier: {e}"
    if clf.endswith(".onnx"):
        # a fused emission loads as deploy form, a name-preserving torch
        # export maps by name
        from litepi_tpu_torch.weights.onnx_import import (
            convert_classifier_onnx,
            convert_classifier_onnx_fused,
        )

        try:
            if args.clf_arch == "shufflenetv2":
                try:
                    return convert_classifier_onnx_fused(clf)
                except ValueError:
                    pass
            return convert_classifier_onnx(args.clf_arch, clf), None
        except (OSError, ValueError, KeyError) as e:
            return f"--classifier: {e}"
    if clf.endswith(".xml"):
        from litepi_tpu_torch.weights.openvino_import import (
            convert_classifier_openvino_fused,
        )

        try:
            return convert_classifier_openvino_fused(clf, clf[: -len(".xml")] + ".bin")
        except (OSError, ValueError) as e:
            return f"--classifier: {e}"
    try:
        return load_checkpoint(clf), None
    except ValueError as e:
        return f"--classifier: {e}"


def build_pipeline(args: argparse.Namespace):
    """The pipeline that :func:`main` evaluates with, from parsed ``args``
    (completed in place: ``detector_variant``, ``num_classes``), allowing
    TF32 around its calls as ``--matmul_precision`` says; a message (str)
    where a flag or an artifact is refused."""
    # infer the variant from a deployed graph's topology, so that
    # --detector_variant can stay unset (the reference CLI has no such flag)
    probe = None
    if args.detector_param:
        if not args.detector_bin:
            return "--detector_param needs --detector_bin"
        probe = _probe_ncnn(args, list(dict.fromkeys([args.det_input_size, 640])))
    elif args.detector and args.detector.endswith(".xml"):
        probe = _probe_openvino(args)
    if isinstance(probe, str):
        return probe
    if probe is not None:
        inferred = probe[2]
        if args.detector_variant and args.detector_variant != inferred:
            return (f"--detector_variant {args.detector_variant} conflicts with "
                    f"the artifact's topology ({inferred})")
        args.detector_variant = inferred

    from litepi_tpu_torch.core.device import resolve_device
    from litepi_tpu_torch.core.types import (
        DATASET_PRESETS,
        YOLO_PLUS_V1,
        YOLO_PLUS_V2,
        YOLOV8N,
        NMSConfig,
        PipelineConfig,
    )

    device = resolve_device(args.device)
    preset = DATASET_PRESETS[args.dataset]
    if args.num_classes is None:
        args.num_classes = preset["num_classes"]
    if args.detector_variant is None:
        args.detector_variant = preset["detector_variant"]
    stats = {}
    for key in ("cls_mean", "cls_std"):
        vals = getattr(args, key)
        if vals is not None and len(vals) not in (1, 3):
            return f"--{key} takes 1 or 3 floats"
        stats[key] = preset[key] if vals is None else tuple(vals * (3 // len(vals)))

    from litepi_tpu_torch.models import YoloLitePi, build_classifier, detector_kwargs
    from litepi_tpu_torch.pipeline import TwoStagePipeline
    from litepi_tpu_torch.weights.jax_bridge import jax_to_state_dict
    from litepi_tpu_torch.weights.seeded import seeded_state

    # the zoo detectors share yolov8n's stride-8/16/32 grid for the NMS
    # budgets; their own models (and decoder) come from detector_kwargs
    det_cfg = {"yolo_plus_v2": YOLO_PLUS_V2, "yolo_plus_v1": YOLO_PLUS_V1}.get(
        args.detector_variant, YOLOV8N)
    cfg = PipelineConfig(
        detector=dataclasses.replace(det_cfg, input_size=args.det_input_size),
        nms=NMSConfig(
            iou_threshold=args.iou_threshold,
            max_candidates=args.max_candidates,
            max_detections=args.max_det,
            min_area=args.min_area,
            eval_max_candidates=args.eval_max_candidates,
            eval_max_detections=args.eval_max_det,
        ),
        classifier_arch=args.clf_arch,
        num_classifier_classes=args.num_classes,
        det_input_size=args.det_input_size,
        cls_input_size=args.cls_input_size,
        # frames arrive as cv2-BGR; compute is RGB (reference e2e.py:224)
        input_color="bgr",
        batch_size=args.batch_size,
        yolo_conf=args.yolo_conf,
        benchmark_conf=args.benchmark_conf,
        cls_mean=stats["cls_mean"],
        cls_std=stats["cls_std"],
        roi_impl=args.roi_impl,
    )
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32

    # ---- weights ----------------------------------------------------- #
    zoo = (detector_kwargs(args.detector_variant, cfg, device)
           if args.detector_variant in ("yolov11n", "yolov5n", "yolov5n_legacy") else {})
    det_vars = _load_detector(args, cfg, probe)
    if isinstance(det_vars, str):
        return det_vars
    if det_vars is None:
        print("[warn] no --detector checkpoint: using random weights", file=sys.stderr)
        det_state = seeded_state(zoo.get("det_model") or YoloLitePi(cfg.detector), seed=0)
    else:
        det_state = jax_to_state_dict(det_vars)
    loaded = _load_classifier(args)
    if isinstance(loaded, str):
        return loaded
    cls_vars, ncls = loaded
    if ncls is not None and ncls != args.num_classes:
        return (f"--classifier graph has {ncls} classes, --num_classes says "
                f"{args.num_classes}")
    if cls_vars is None:
        print("[warn] no --classifier weights: using random weights", file=sys.stderr)
        cls_state = seeded_state(build_classifier(args.clf_arch, args.num_classes), seed=1)
    else:
        cls_state = jax_to_state_dict(cls_vars)

    return TwoStagePipeline(
        cfg, det_state, cls_state, dtype, device, **zoo,
        allow_tf32=apply_matmul_precision(args.matmul_precision, dtype))


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    pipe = build_pipeline(args)
    if isinstance(pipe, str):
        return _error(pipe)

    from litepi_tpu_torch.evals.labels import load_class_names, sample_images
    from litepi_tpu_torch.pipeline import PipelineEvaluator
    from litepi_tpu_torch.pipeline.evaluator import write_results

    class_names = load_class_names(args.classes)

    # ---- data + eval -------------------------------------------------- #
    image_paths = sample_images(args.input, args.num_samples, args.seed)
    if not image_paths:
        return _error(f"no images found in {args.input}")
    print(f"Evaluating {len(image_paths)} images from {args.input}")

    combo = f"{args.detector_variant}+{args.clf_arch}"
    metrics = PipelineEvaluator(pipe, class_names).evaluate_dataset(
        image_paths,
        args.labels,
        num_classes=args.num_classes,
        yolo_conf=args.yolo_conf,
        benchmark_conf=args.benchmark_conf,
        warmup=args.warmup,
        viz_dir=os.path.join(args.output, combo, "viz") if args.save_viz else None,
        metrics_mode=args.metrics,
    )
    write_results(args.output, combo, args.detector_variant, args.clf_arch, metrics,
                  image_paths, class_names)
    print(
        f"\n=== {combo} ===\n"
        f"images: {metrics['num_images']}  fps: {metrics['fps']:.2f}\n"
        f"precision: {metrics['precision']:.4f}  recall: {metrics['recall']:.4f}"
        f"  f1: {metrics['f1']:.4f}\n"
        f"mAP@0.5: {metrics['mAP50']:.4f}  mAP@0.5:0.95: {metrics['mAP50_95']:.4f}\n"
        f"stage ms/batch: {metrics['stage_ms_per_batch']}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
