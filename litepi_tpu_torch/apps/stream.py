"""Streaming / multi-mode app of the PyTorch port: camera, video, folder and
single-image modes, flag-compatible with the JAX package's
``apps/stream.py`` (``--device`` takes ``cuda`` / ``cpu``).

It re-creates the reference's deployed Pi app, ``full_appv3.py``
(src/tt100k/pipeline/full_appv3.py:584-649: ``--mode
{camera,video,folder,single}``, a detection + classification overlay per
frame, an EMA-smoothed FPS, a ``VideoWriter`` output and per-frame CSV rows
with an empty placeholder row for a frame with no detection,
:320-334,406-430) on the port's fused program
(``TwoStagePipeline.run_fused``: the NMS and ROI kernels on the card), in
bf16 with 256 candidates.  Video frames go to the card in batches of
``--batch_size``; the other modes send one frame at a time.

Weights come from a port checkpoint, the importers (``.onnx``,
``.param`` + sibling ``.bin``, ``.xml`` + sibling ``.bin``, ``.pt`` /
``.pth``) or, without ``--detector`` / ``--classifier``, seeded random
weights (``weights/seeded.py``).  It runs on the card (``--device cuda``,
the default; it raises without one) or with ``--device cpu``.

Usage:
    python -m litepi_tpu_torch.apps.stream --mode video --input clip.mp4 \\
        --detector det.onnx --classifier clf.pth --save_video out.mp4 \\
        --save_csv frames.csv
"""

from __future__ import annotations

import argparse
import csv
import os
import pickle
import sys
import time
from typing import Dict, List, Optional

import numpy as np

CSV_HEADER = ["frame", "x1", "y1", "x2", "y2", "det_conf", "class_name", "cls_conf"]


def draw_detections(frame, result, class_names, cls_conf_gate: float = 0.5) -> int:
    """Overlay boxes and labels on ``frame`` in place (the reference's
    drawing loop, full_appv3.py:205-283; the classifier's label only above
    the cls-conf gate, :274); returns the number drawn."""
    import cv2

    n = 0
    for i in range(len(result["boxes"])):
        if not result["valid"][i]:
            continue
        x1, y1, x2, y2 = (int(v) for v in result["boxes"][i])
        det_conf = float(result["det_scores"][i])
        cls_id = int(result["cls_labels"][i])
        cls_conf = float(result["cls_scores"][i])
        name = class_names.get(cls_id, str(cls_id)) if class_names else str(cls_id)
        label = f"{name} {cls_conf:.2f}" if cls_conf >= cls_conf_gate else f"sign {det_conf:.2f}"
        cv2.rectangle(frame, (x1, y1), (x2, y2), (0, 255, 0), 2)
        cv2.putText(frame, label, (x1, max(y1 - 6, 12)), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                    (0, 255, 0), 1)
        n += 1
    return n


def result_rows(frame_idx: int, result: Optional[Dict[str, np.ndarray]],
                class_names) -> List[List[object]]:
    """Per-frame CSV rows; a frame with no detection gives one empty
    placeholder row (the reference's contract, full_appv3.py:320-334)."""
    rows: List[List[object]] = []
    if result is not None:
        for i in range(len(result["boxes"])):
            if not result["valid"][i]:
                continue
            x1, y1, x2, y2 = (float(v) for v in result["boxes"][i])
            cls_id = int(result["cls_labels"][i])
            name = class_names.get(cls_id, str(cls_id)) if class_names else str(cls_id)
            rows.append([frame_idx, x1, y1, x2, y2, float(result["det_scores"][i]), name,
                         float(result["cls_scores"][i])])
    if not rows:
        rows.append([frame_idx, "", "", "", "", "", "", ""])
    return rows


def _to_host(out) -> Dict[str, np.ndarray]:
    """``run_fused``'s device tensors as numpy arrays (one copy per key)."""
    return {k: v.cpu().numpy() for k, v in out.items()}


def _unbatch(out, i) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v[i]) for k, v in out.items()}


def _put_fps(frame, fps: float) -> None:
    import cv2

    cv2.putText(frame, f"FPS {fps:.1f}", (10, 26), cv2.FONT_HERSHEY_SIMPLEX, 0.8,
                (0, 200, 255), 2)


def run_video(pipe, args, class_names) -> int:
    import cv2

    cap = cv2.VideoCapture(args.input)
    if not cap.isOpened():
        print(f"error: cannot open video {args.input}", file=sys.stderr)
        return 2
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    fps_in = cap.get(cv2.CAP_PROP_FPS) or 30.0
    writer = None
    if args.save_video:
        writer = cv2.VideoWriter(args.save_video, cv2.VideoWriter_fourcc(*"mp4v"), fps_in,
                                 (w, h))
    csv_f = open(args.save_csv, "w", newline="") if args.save_csv else None
    csv_w = csv.writer(csv_f) if csv_f else None
    if csv_w:
        csv_w.writerow(CSV_HEADER)

    bs = args.batch_size
    ema_fps, frame_idx, done = 0.0, 0, False
    while not done:
        frames = []
        while len(frames) < bs:
            ok, frame = cap.read()
            if not ok:
                done = True
                break
            frames.append(frame)
        if not frames:
            break
        # a trailing partial batch is padded with its last frame
        batch = np.stack(frames + [frames[-1]] * (bs - len(frames)))
        t0 = time.perf_counter()
        out = _to_host(pipe.run_fused(batch, conf_threshold=args.conf))
        inst_fps = len(frames) / (time.perf_counter() - t0)
        # EMA smoothing 0.8 / 0.2 (full_appv3.py:317)
        ema_fps = inst_fps if ema_fps == 0 else 0.8 * ema_fps + 0.2 * inst_fps
        for i, frame in enumerate(frames):
            res = _unbatch(out, i)
            draw_detections(frame, res, class_names)
            _put_fps(frame, ema_fps)
            if writer is not None:
                writer.write(frame)
            if csv_w:
                csv_w.writerows(result_rows(frame_idx, res, class_names))
            frame_idx += 1
        if frame_idx % (bs * 10) == 0:
            print(f"frame {frame_idx}  fps {ema_fps:.1f}")
    cap.release()
    if writer is not None:
        writer.release()
    if csv_f:
        csv_f.close()
    print(f"processed {frame_idx} frames, mean device fps {ema_fps:.1f}")
    return 0


def run_folder(pipe, args, class_names) -> int:
    import cv2

    from litepi_tpu_torch.evals.labels import sample_images

    paths = sample_images(args.input)
    if not paths:
        print(f"error: no images in {args.input}", file=sys.stderr)
        return 2
    os.makedirs(args.output, exist_ok=True)
    csv_path = args.save_csv or os.path.join(args.output, "detections.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(CSV_HEADER)
        for idx, p in enumerate(paths):
            frame = cv2.imread(p)
            if frame is None:
                continue
            res = _unbatch(_to_host(pipe.run_fused(frame[None], conf_threshold=args.conf)), 0)
            n = draw_detections(frame, res, class_names)
            w.writerows(result_rows(idx, res, class_names))
            cv2.imwrite(os.path.join(args.output, os.path.basename(p)), frame)
            print(f"{os.path.basename(p)}: {n} detections")
    return 0


def run_single(pipe, args, class_names) -> int:
    import cv2

    frame = cv2.imread(args.input)
    if frame is None:
        print(f"error: cannot read {args.input}", file=sys.stderr)
        return 2
    res = _unbatch(_to_host(pipe.run_fused(frame[None], conf_threshold=args.conf)), 0)
    n = draw_detections(frame, res, class_names)
    out_path = args.save_image or "out_" + os.path.basename(args.input)
    cv2.imwrite(out_path, frame)
    print(f"{n} detections -> {out_path}")
    for i in range(len(res["boxes"])):
        if res["valid"][i]:
            cls_id = int(res["cls_labels"][i])
            name = class_names.get(cls_id, str(cls_id)) if class_names else str(cls_id)
            print(f"  box {np.round(res['boxes'][i], 1).tolist()} "
                  f"det {res['det_scores'][i]:.3f} -> {name} ({res['cls_scores'][i]:.3f})")
    return 0


def run_camera(pipe, args, class_names) -> int:
    """The live-camera loop (reference: full_appv2.py:166-207 /
    full_appv3.py:288); it ends when ``cap.read()`` stops delivering
    frames, or on ``q`` with ``--show_video``."""
    import cv2

    cap = cv2.VideoCapture(args.cam_id)
    if not cap.isOpened():
        print(f"error: cannot open camera {args.cam_id}", file=sys.stderr)
        return 2
    ema_fps = 0.0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            t0 = time.perf_counter()
            res = _unbatch(_to_host(pipe.run_fused(frame[None], conf_threshold=args.conf)), 0)
            inst = 1.0 / max(time.perf_counter() - t0, 1e-6)
            ema_fps = inst if ema_fps == 0 else 0.8 * ema_fps + 0.2 * inst
            draw_detections(frame, res, class_names)
            _put_fps(frame, ema_fps)
            if args.show_video:
                cv2.imshow("litepi_tpu_torch", frame)
                if cv2.waitKey(1) & 0xFF == ord("q"):
                    break
    finally:
        cap.release()
        cv2.destroyAllWindows()
    return 0


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Streaming TSR app (PyTorch port)")
    p.add_argument("--mode", default="single", choices=["camera", "video", "folder", "single"])
    p.add_argument("--input", default=None, help="video/image/folder path")
    p.add_argument("--cam_id", type=int, default=0)
    p.add_argument("--detector", default=None)
    p.add_argument("--detector_variant", default="yolo_plus_v2",
                   choices=["yolo_plus_v2", "yolo_plus_v1", "yolov8n"])
    p.add_argument("--classifier", default=None)
    p.add_argument("--clf_arch", default="efficientnet",
                   choices=["resnet18", "efficientnet", "mobilenetv2", "shufflenetv2"])
    p.add_argument("--num_classes", type=int, default=91)
    p.add_argument("--classes", default=None)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--yolo_iou", type=float, default=0.45)
    p.add_argument("--img_size", type=int, default=640)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_det", type=int, default=16)
    p.add_argument("--output", default="stream_out")
    p.add_argument("--save_video", default=None)
    p.add_argument("--save_csv", default=None)
    p.add_argument("--save_image", default=None)
    p.add_argument("--show_video", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def _detector_vars(det: Optional[str], det_cfg):
    """Flax-named detector variables from ``--detector``'s artifact, None
    for seeded random weights; raises OSError / ValueError / KeyError /
    UnpicklingError for an artifact that does not load."""
    if not det:
        return None
    if det.endswith(".onnx"):
        from litepi_tpu_torch.weights.onnx_import import convert_detector_onnx

        return convert_detector_onnx(det, det_cfg.depths)
    if det.endswith(".param"):
        from litepi_tpu_torch.weights.ncnn_import import convert_detector_ncnn

        return convert_detector_ncnn(det, det[: -len(".param")] + ".bin", det_cfg)[0]
    if det.endswith(".xml"):
        from litepi_tpu_torch.weights.openvino_import import convert_detector_openvino

        return convert_detector_openvino(det, det[: -len(".xml")] + ".bin", det_cfg)[0]
    if det.endswith((".pt", ".pth")):
        from litepi_tpu_torch.weights.onnx_import import defuse_state_dict
        from litepi_tpu_torch.weights.torch_import import (
            convert_detector_state_dict,
            load_torch_state_dict,
        )

        return convert_detector_state_dict(defuse_state_dict(load_torch_state_dict(det)),
                                           det_cfg.depths)
    from litepi_tpu_torch.weights.checkpoint import load_checkpoint

    return load_checkpoint(det)


def _classifier_vars(args):
    """Flax-named classifier variables from ``--classifier``, None for
    seeded random weights, or an rc-2 message."""
    clf = args.classifier
    if not clf:
        return None
    if clf.endswith((".pth", ".pt")):
        from litepi_tpu_torch.weights.torch_import import (
            convert_classifier_state_dict,
            load_torch_state_dict,
        )

        return convert_classifier_state_dict(args.clf_arch, load_torch_state_dict(clf))
    if clf.endswith((".param", ".onnx", ".xml")):
        # graph-form classifiers are the canonical ShuffleNetV2 emission
        # (deploy form; the pipeline recognises the folded variables)
        if args.clf_arch != "shufflenetv2":
            return ("graph-form --classifier covers shufflenetv2 (the deployed "
                    "classifier); convert other archs from .pth")
        try:
            if clf.endswith(".param"):
                from litepi_tpu_torch.weights.ncnn_import import convert_classifier_ncnn

                return convert_classifier_ncnn(clf, clf[: -len(".param")] + ".bin")[0]
            if clf.endswith(".onnx"):
                from litepi_tpu_torch.weights.onnx_import import convert_classifier_onnx_fused

                return convert_classifier_onnx_fused(clf)[0]
            from litepi_tpu_torch.weights.openvino_import import (
                convert_classifier_openvino_fused,
            )

            return convert_classifier_openvino_fused(clf, clf[: -len(".xml")] + ".bin")[0]
        except (OSError, ValueError) as e:
            return f"--classifier: {e}"
    from litepi_tpu_torch.weights.checkpoint import load_checkpoint

    try:
        return load_checkpoint(clf)
    except ValueError as e:
        return f"--classifier: {e}"


def build_pipeline(args):
    """The app's bf16 pipeline on ``--device`` from parsed ``args``, or an
    rc-2 message."""
    import torch

    from litepi_tpu_torch.core.device import resolve_device
    from litepi_tpu_torch.core.types import (
        YOLO_PLUS_V1,
        YOLO_PLUS_V2,
        YOLOV8N,
        NMSConfig,
        PipelineConfig,
    )
    from litepi_tpu_torch.models import YoloLitePi, build_classifier
    from litepi_tpu_torch.pipeline import TwoStagePipeline
    from litepi_tpu_torch.weights.jax_bridge import jax_to_state_dict
    from litepi_tpu_torch.weights.seeded import seeded_state

    device = resolve_device(args.device)  # raises without a card
    det_cfg = {"yolo_plus_v2": YOLO_PLUS_V2, "yolo_plus_v1": YOLO_PLUS_V1,
               "yolov8n": YOLOV8N}[args.detector_variant]
    cfg = PipelineConfig(
        detector=det_cfg,
        nms=NMSConfig(conf_threshold=args.conf, iou_threshold=args.yolo_iou,
                      max_detections=args.max_det, max_candidates=256),
        classifier_arch=args.clf_arch,
        num_classifier_classes=args.num_classes,
        det_input_size=args.img_size,
        batch_size=args.batch_size,
        # cv2 frames are BGR; compute is RGB
        input_color="bgr",
    )
    # the reference's app runs an exported detector graph directly
    # (full_appv3.py:68 YOLOv8ONNX): the e2e CLI's artifact forms
    try:
        det_vars = _detector_vars(args.detector, det_cfg)
    except (OSError, ValueError, KeyError, pickle.UnpicklingError) as e:
        return f"--detector: {e}"
    cls_vars = _classifier_vars(args)
    if isinstance(cls_vars, str):
        return cls_vars
    det_state = (seeded_state(YoloLitePi(cfg.detector), seed=0) if det_vars is None
                 else jax_to_state_dict(det_vars))
    cls_state = (seeded_state(build_classifier(args.clf_arch, args.num_classes), seed=1)
                 if cls_vars is None else jax_to_state_dict(cls_vars))
    return TwoStagePipeline(cfg, det_state, cls_state, torch.bfloat16, device)


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.mode != "camera" and not args.input:
        print("error: --input required for this mode", file=sys.stderr)
        return 2
    pipe = build_pipeline(args)
    if isinstance(pipe, str):
        print(f"error: {pipe}", file=sys.stderr)
        return 2

    from litepi_tpu_torch.evals.labels import load_class_names

    mode_fn = {"video": run_video, "folder": run_folder, "single": run_single,
               "camera": run_camera}[args.mode]
    return mode_fn(pipe, args, load_class_names(args.classes))


if __name__ == "__main__":
    sys.exit(main())
