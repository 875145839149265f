"""Detector fair benchmark: per-variant accuracy and per-stage speed.

The port's copy of the JAX package's ``bench/detector_bench.py`` (after the
reference's ``evaluation_tsd.ipynb`` cell 5, ``evaluation_tsd_single_img
.ipynb`` and ``evaluation_tsd_single_img_other.ipynb``): every variant as
three staged programs, ``pre`` (device frames -> model input), ``infer``
and ``post`` (-> padded boxes, scores, class ids, valid), timed with the
reference protocol (warmup 5, timed 20) at each stage boundary, and
evaluated for mAP on a labelled folder through the reference-exact
evaluator.  The YOLO family shares the letterbox ``pre`` and the NMS
``post``; SSD300 (fixed at 300x300) and Faster R-CNN resize plainly
(``ops/resize.py``, ``jax.image.resize``'s antialiased bilinear) and bring
their own ``post``.  On the card every NMS is the NMS kernel (K1): K =
``max_candidates`` for the YOLO family and SSD300, K = ``post_nms_topk``
(256) class-aware for Faster R-CNN, whose RPN also runs it at K = 1,024.

Without weights each variant starts from seeded random ones
(``train/detector.py::flax_init_``, the port's counterpart of the JAX
package's ``fast_init``: the same distributions, not the same numbers).
Weights given are Flax-named trees (``weights/checkpoint.py``, as the
training CLIs write them), carried in by ``weights/jax_bridge.py``.

Usage:
    python -m litepi_tpu_torch.bench.detector_bench --variants ssd300 \\
        faster_rcnn --batch 1 [--images I --labels L] [--checkpoint DIR] \\
        [--device cpu]
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from litepi_tpu_torch.core.types import YOLO_PLUS_V1, YOLO_PLUS_V2, YOLOV8N, DetectorConfig

# anchor-free YoloLitePi-family variants (the {reg, cls} head contract)
LITE_VARIANTS: Dict[str, DetectorConfig] = {
    "yolo_plus_v2": YOLO_PLUS_V2,
    "yolo_plus_v1": YOLO_PLUS_V1,
    "yolov8n": YOLOV8N,
}
# every benchmarkable variant
ALL_VARIANTS = (
    "yolo_plus_v2",
    "yolo_plus_v1",
    "yolov8n",
    "yolov11n",
    "yolov5n",  # the anchor-free u-variant the reference deployed
    "yolov5n_legacy",  # the 3-prior anchor head + v5 decode
    "ssd300",
    "faster_rcnn",
)


@dataclasses.dataclass
class DetectorHarness:
    """One variant's staged programs: ``pre`` (B, H, W, 3) uint8 device
    frames -> model input; ``infer`` -> raw outputs; ``post`` -> (boxes,
    scores, class_ids, valid) padded, boxes in model-input pixels;
    ``geometry`` 'letterbox' (YOLO family) or 'resize' (SSD / Faster
    R-CNN), how boxes map back to the frame."""

    name: str
    input_size: int
    geometry: str
    pre: Callable
    infer: Callable
    post: Callable

    def predict(self, frames: torch.Tensor):
        with torch.inference_mode():
            return self.post(self.infer(self.pre(frames)))

    def unmap_boxes(self, boxes: np.ndarray, orig_w: int, orig_h: int) -> np.ndarray:
        """Model-input boxes -> clipped original-pixel boxes (host numpy)."""
        from litepi_tpu_torch.ops.letterbox import letterbox_params

        if self.geometry == "letterbox":
            r, dw, dh, _, _ = letterbox_params(orig_h, orig_w, self.input_size)
            out = (boxes - np.asarray([dw, dh, dw, dh])) / r
        else:
            sx = orig_w / self.input_size
            sy = orig_h / self.input_size
            out = boxes * np.asarray([sx, sy, sx, sy])
        out[..., [0, 2]] = out[..., [0, 2]].clip(0, orig_w)
        out[..., [1, 3]] = out[..., [1, 3]].clip(0, orig_h)
        return out


def _load(model: torch.nn.Module, det_vars, seed: int) -> torch.nn.Module:
    from litepi_tpu_torch.train.detector import flax_init_
    from litepi_tpu_torch.weights.jax_bridge import jax_to_state_dict

    if det_vars is None:
        return flax_init_(model, torch.Generator().manual_seed(seed))
    model.load_state_dict(jax_to_state_dict(det_vars))
    return model


def _place_yolo(model: torch.nn.Module, device, dtype) -> torch.nn.Module:
    """A YOLO-family model on ``device`` in ``dtype`` for inference, its
    BatchNorm kept in float32 as the JAX models' (the pipeline's
    ``_place``)."""
    model = model.eval().to(device=device, dtype=dtype)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.float()
    return model


def _without_tf32(fn: Callable) -> Callable:
    """``fn`` run with TF32 off (``weights/graph_ops.py::tf32_allowed``)."""
    from litepi_tpu_torch.weights.graph_ops import tf32_allowed

    def run(x):
        with tf32_allowed(False):
            return fn(x)

    return run


def make_harness(
    variant: str,
    input_size: int = 640,
    dtype: str = "bfloat16",
    seed: int = 0,
    num_classes: int = 1,
    conf: float = 0.25,
    iou: float = 0.45,
    max_detections: int = 64,
    max_candidates: int = 256,
    det_vars=None,
    input_color: str = "rgb",
    device="cuda",
) -> DetectorHarness:
    """The staged programs of any variant of :data:`ALL_VARIANTS` on
    ``device`` (the card unless the caller asks for the CPU).
    ``input_color="bgr"`` reverses the channel axis in ``pre`` (cv2
    frames; the models compute in RGB).  In float32 each stage runs with
    TF32 off and gives the caller's flags back when it returns."""
    from litepi_tpu_torch.core.device import resolve_device
    from litepi_tpu_torch.ops.nms import nms_sorted

    dev = resolve_device(device)
    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def harness(name, size, geometry, pre, infer, post) -> DetectorHarness:
        if tdtype == torch.float32:
            pre, infer, post = (_without_tf32(f) for f in (pre, infer, post))
        return DetectorHarness(name, size, geometry, pre, infer, post)

    def to_rgb(f):
        return f.flip(-1) if input_color == "bgr" else f

    if variant in LITE_VARIANTS or variant in ("yolov11n", "yolov5n", "yolov5n_legacy"):
        from litepi_tpu_torch.models import YoloLitePi, YoloV5, YoloV11
        from litepi_tpu_torch.ops.anchors import make_anchors
        from litepi_tpu_torch.ops.dfl import decode_candidates
        from litepi_tpu_torch.ops.letterbox import letterbox_nchw

        reg_max, strides = 16, (8, 16, 32)
        if variant == "yolov11n":
            model = YoloV11(num_classes=num_classes)
        elif variant == "yolov5n":
            model = YoloV5(num_classes=num_classes, anchor_free=True)
        elif variant == "yolov5n_legacy":
            model = YoloV5(num_classes=num_classes)
        else:
            cfg = dataclasses.replace(LITE_VARIANTS[variant], num_classes=num_classes,
                                      input_size=input_size)
            model = YoloLitePi(cfg)
            reg_max, strides = cfg.reg_max, cfg.strides
        model = _place_yolo(_load(model, det_vars, seed), dev, tdtype)

        def pre(f):
            return letterbox_nchw(to_rgb(f), input_size, tdtype) * (1.0 / 255.0)

        if variant == "yolov5n_legacy":
            from litepi_tpu_torch.models.yolov5 import V5CandidateDecoder

            decoder = V5CandidateDecoder(input_size, dev)

            def candidates(out):
                return decoder(out, max_candidates)
        else:
            pts, strd = make_anchors(input_size, strides)
            anchors, stride_t = torch.from_numpy(pts).to(dev), torch.from_numpy(strd).to(dev)

            def candidates(out):
                return decode_candidates(out, anchors, stride_t, reg_max, max_candidates)

        def post(out):
            boxes, scores, cls = candidates(out)
            return nms_sorted(boxes.contiguous(), scores, cls, conf, iou, max_detections)

        return harness(variant, input_size, "letterbox", pre, model, post)

    from litepi_tpu_torch.ops.boxes import clip_boxes
    from litepi_tpu_torch.ops.resize import resize_bilinear

    if variant == "ssd300":
        from litepi_tpu_torch.models.ssd import SSD300, decode_ssd_boxes

        size = 300
        model = _load(SSD300(num_classes=num_classes, dtype=tdtype), det_vars, seed)
        model = model.eval().to(dev)

        def pre(f):
            x = resize_bilinear(to_rgb(f), size, size).to(tdtype) * (1.0 / 255.0)
            return x.permute(0, 3, 1, 2)

        def post(out):
            probs = torch.softmax(out["conf"], dim=-1)[..., 1:]
            scores = probs.amax(-1)
            labels = probs.argmax(-1).to(torch.int32)
            boxes = clip_boxes(decode_ssd_boxes(out["loc"], model.default_boxes), size, size)
            order = torch.sort(-scores, dim=-1, stable=True)[1][..., :max_candidates]
            boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
            return nms_sorted(boxes.contiguous(), torch.gather(scores, 1, order),
                              torch.gather(labels, 1, order), conf, iou, max_detections)

        return harness(variant, size, "resize", pre, model, post)

    if variant == "faster_rcnn":
        from litepi_tpu_torch.models.faster_rcnn import FasterRCNN, postprocess_detections
        from litepi_tpu_torch.train.detector import compute_params

        model = FasterRCNN(num_classes=num_classes, input_size=input_size, dtype=tdtype)
        model = _load(model, det_vars, seed).eval().to(dev)
        with torch.no_grad():
            cast = compute_params(model, tdtype)  # the bf16 conv weights, cast once

        def pre(f):
            x = resize_bilinear(to_rgb(f), input_size, input_size).to(tdtype) * (1.0 / 255.0)
            return x.permute(0, 3, 1, 2)

        def infer(x):
            return torch.func.functional_call(model, cast, (x,), strict=False)

        def post(out):
            return postprocess_detections(out, input_size, conf, iou, max_detections)

        return harness(variant, input_size, "resize", pre, infer, post)

    raise ValueError(f"unknown detector variant: {variant!r}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark_detector(
    variant: str = "yolo_plus_v2",
    det_vars=None,
    batch: int = 1,
    warmup: int = 5,
    iters: int = 20,
    input_size: int = 640,
    dtype: str = "bfloat16",
    images: Optional[np.ndarray] = None,
    seed: int = 42,
    device="cuda",
    num_classes: int = 1,
) -> Dict[str, float]:
    """Warmup-then-timed benchmark, the reference protocol (dummy frames,
    warmup 5, timed 20), split into pre / infer / post.  Each stage ends in
    a device synchronisation (its host milliseconds) with CUDA events
    around it on the card (its device milliseconds, ``*_device_ms``)."""
    from litepi_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    h = make_harness(variant, input_size=input_size, dtype=dtype, det_vars=det_vars,
                     num_classes=num_classes, device=dev)
    if images is None:
        rng = np.random.default_rng(seed)
        images = rng.integers(0, 256, (batch, input_size, input_size, 3), np.uint8)
    frames = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
    cuda = dev.type == "cuda"

    def stage_times():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)] if cuda else None
        stamps = [time.perf_counter()]
        with torch.inference_mode():
            x = frames
            for i, stage in enumerate((h.pre, h.infer, h.post)):
                if cuda:
                    ev[i].record()
                x = stage(x)
                if cuda and i == 2:
                    ev[3].record()
                _sync(dev)
                stamps.append(time.perf_counter())
        host = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        if not cuda:
            return host, [float("nan")] * 3
        # each stage's events bracket its own launches (the next stage's
        # start event is recorded after the synchronisation)
        return host, [ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                      ev[2].elapsed_time(ev[3])]

    for _ in range(warmup):
        stage_times()
    sums, dsums = np.zeros(3), np.zeros(3)
    for _ in range(iters):
        host, dev_ms = stage_times()
        sums += host
        dsums += dev_ms
    pre, inf, post = sums / iters
    total = pre + inf + post
    row = {
        "model": variant,
        "backend": dev.type,
        "batch": int(frames.shape[0]),
        "pre_ms": round(pre, 3),
        "infer_ms": round(inf, 3),
        "post_ms": round(post, 3),
        "total_ms": round(total, 3),
        "fps": round(frames.shape[0] / (total / 1e3), 2),
    }
    if cuda:
        row.update({f"{k}_device_ms": round(float(v), 4)
                    for k, v in zip(("pre", "infer", "post"), dsums / iters)})
    return row


def evaluate_detector(
    variant: str,
    images_dir: str,
    labels_dir: str,
    det_vars=None,
    num_classes: int = 1,
    input_size: int = 640,
    dtype: str = "float32",
    conf: float = 0.001,
    iou: float = 0.45,
    max_detections: int = 300,
    max_images: Optional[int] = 50,
    seed: int = 42,
    device="cuda",
) -> Dict[str, float]:
    """mAP of any variant on a YOLO-format labelled folder through the
    reference-exact evaluator: cv2 frames, letterboxed or resized on the
    host to the model's input, one image at a time."""
    import cv2

    from litepi_tpu_torch.evals.labels import parse_yolo_label, sample_images
    from litepi_tpu_torch.evals.reference import evaluate_predictions_reference
    from litepi_tpu_torch.ops.letterbox import letterbox_host

    h = make_harness(
        variant, input_size=input_size, dtype=dtype, det_vars=det_vars,
        num_classes=num_classes, conf=conf, iou=iou, max_detections=max_detections,
        max_candidates=max(1024, max_detections),
        input_color="bgr",  # frames come from cv2.imread
        device=device,
    )
    dev = torch.device(device)
    all_preds, all_gts = [], []
    for p in sample_images(images_dir, max_images, seed=seed):
        img = cv2.imread(p)
        if img is None:
            continue
        # fixed-shape canvas on the host, as the JAX bench feeds its programs
        if h.geometry == "letterbox":
            canvas, _, _ = letterbox_host(img, h.input_size)
        else:
            canvas = cv2.resize(img, (h.input_size, h.input_size),
                                interpolation=cv2.INTER_LINEAR)
        frames = torch.from_numpy(np.ascontiguousarray(canvas[None])).to(dev)
        b, s, c, v = (t.cpu().numpy() for t in h.predict(frames))
        keep = v[0]
        boxes = h.unmap_boxes(b[0][keep], img.shape[1], img.shape[0])
        all_preds.append((boxes, s[0][keep], c[0][keep].astype(np.int64)))
        lp = os.path.join(labels_dir, os.path.splitext(os.path.basename(p))[0] + ".txt")
        gb, gc = parse_yolo_label(lp, img.shape[1], img.shape[0])
        all_gts.append((gb, gc.astype(np.int64)))
    m = evaluate_predictions_reference(all_preds, all_gts, num_classes)
    return {
        "model": variant,
        "num_images": len(all_preds),
        "mAP50": round(float(m["mAP50"]), 4),
        "mAP50_95": round(float(m["mAP50_95"]), 4),
        "precision": round(float(m["mean_precision"]), 4),
        "recall": round(float(m["mean_recall"]), 4),
    }


def run_fair_benchmark(
    variants: Sequence[str] = ("yolo_plus_v2", "yolo_plus_v1", "yolov8n"), **kw
) -> List[Dict[str, float]]:
    """Every variant under the same protocol."""
    return [benchmark_detector(v, **kw) for v in variants]


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    p = argparse.ArgumentParser(description="Detector fair benchmark (PyTorch port)")
    p.add_argument("--variants", nargs="+", default=["yolo_plus_v2"], choices=list(ALL_VARIANTS))
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--input_size", type=int, default=640)
    p.add_argument("--images", default=None, help="labelled folder -> adds mAP")
    p.add_argument("--labels", default=None)
    p.add_argument("--num_classes", type=int, default=1)
    p.add_argument("--max_images", type=int, default=50)
    p.add_argument(
        "--checkpoint", default=None,
        help="a port checkpoint directory from a training CLI (train_detector / "
        "train_baselines best|last): benches the trained weights of the single "
        "variant given",
    )
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    det_vars = None
    if args.checkpoint:
        if len(args.variants) != 1:
            print("error: --checkpoint applies to exactly one variant", file=sys.stderr)
            return 2
        from litepi_tpu_torch.weights.checkpoint import load_checkpoint

        try:
            det_vars = load_checkpoint(args.checkpoint)
        except ValueError as e:
            print(f"error: --checkpoint: {e}", file=sys.stderr)
            return 2
    for v in args.variants:
        row = benchmark_detector(v, det_vars=det_vars, batch=args.batch, iters=args.iters,
                                 warmup=args.warmup, input_size=args.input_size,
                                 device=args.device, num_classes=args.num_classes)
        if args.images and args.labels:
            row.update(evaluate_detector(v, args.images, args.labels, det_vars=det_vars,
                                         num_classes=args.num_classes,
                                         input_size=args.input_size,
                                         max_images=args.max_images, device=args.device))
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
