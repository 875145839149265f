"""Dataset evaluation: the reference ``e2e.py`` main loop on the
port's pipeline, the JAX package's ``pipeline/evaluator.py`` in PyTorch.

Reference flow per image (process_image, e2e.py:955-1011): imread -> parse
YOLO label -> PASS 1 at benchmark_conf (timed, the "real FPS" number) ->
PASS 2 at yolo_conf=0.001 (the mAP pass) -> accumulate predictions + stage
timings.  Here images run in batches: the benchmark pass is timed through
the fused program (``run_fused``: stem, detector, NMS kernel, ROI crop
kernel, classifier in one issue per batch), and the mAP pass runs the staged
programs with the exact per-class greedy NMS on the host in original-image
space (``eval_budget``).

Host side, as the reference, with cv2 (imported where it is used): decoding
(:meth:`PipelineEvaluator._read_image`), the letterbox
(:func:`~litepi_tpu_torch.ops.letterbox.letterbox_host`), the ROI crops of
the mAP pass (integer-truncated slices of the original image through
``cv2.resize``, e2e.py:459-485) and the annotated images.  The evaluator
runs on its pipeline's device: canvases and crops go up as uint8 and are
divided by 255 there (true division, bit-equal to the host's float32
``/ 255.0``), and each staged call's outputs come back to the host once per
batch.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from litepi_tpu_torch.core.metrics import PipelineMetrics, StageTimer, read_host_counters
from litepi_tpu_torch.evals.labels import parse_yolo_label
from litepi_tpu_torch.evals.level0 import evaluate_predictions_level0
from litepi_tpu_torch.evals.map import evaluate_predictions
from litepi_tpu_torch.evals.reference import evaluate_predictions_reference
from litepi_tpu_torch.ops.letterbox import letterbox_host
from litepi_tpu_torch.ops.nms import nms_numpy_reference
from litepi_tpu_torch.pipeline.two_stage import TwoStagePipeline


def int_crop_coords(boxes: np.ndarray, w: int, h: int):
    """Integer crop geometry shared by the min-area filter and the ROI
    cropper — the reference's exact corner handling (e2e.py:464-471):
    truncate toward zero, clamp the top-left INSIDE the image (a box clipped
    to the right/bottom edge would slice empty and crash cv2.resize), force
    x2 > x1 and y2 > y1.

    boxes: (N, 4) float xyxy.  Returns (xi1, yi1, xi2, yi2) int arrays with
    0 <= xi1 < xi2 <= w and 0 <= yi1 < yi2 <= h.  A box survives the
    min-area filter iff the crop sliced with these integers satisfies it —
    both consumers MUST use this one function.
    """
    if len(boxes) == 0:
        z = np.zeros(0, int)
        return z, z, z, z
    xi1 = np.clip(boxes[:, 0].astype(int), 0, w - 1)
    yi1 = np.clip(boxes[:, 1].astype(int), 0, h - 1)
    xi2 = np.clip(boxes[:, 2].astype(int), xi1 + 1, w)
    yi2 = np.clip(boxes[:, 3].astype(int), yi1 + 1, h)
    return xi1, yi1, xi2, yi2


class PipelineEvaluator:
    """Runs a port :class:`TwoStagePipeline` over labelled images on the
    pipeline's own device (the card by default; a CPU pipeline runs here on
    the CPU)."""

    # classifier call capacity: crops go over in fixed chunks of this size,
    # so the classifier sees one batch shape (one cuDNN plan) for any count
    CLS_CHUNK = 256

    def __init__(
        self,
        pipe: TwoStagePipeline,
        class_names: Optional[Dict[int, str]] = None,
    ) -> None:
        self.pipe = pipe
        self.class_names = class_names or {}
        self.device = pipe.device
        self._255 = torch.full((), 255.0, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------ #

    def _read_image(self, path: str) -> Optional[np.ndarray]:
        """Decode one image file to an (H, W, 3) uint8 BGR array, or None
        where it cannot be read (cv2's contract)."""
        import cv2

        return cv2.imread(path)

    def _to_unit(self, pixels: np.ndarray) -> torch.Tensor:
        """uint8 host pixels -> float32 values / 255 on the pipeline's
        device: up as uint8 (through pinned memory on the card), then a true
        division by a device scalar, bit-equal to numpy's float32
        ``/ 255.0``."""
        t = torch.from_numpy(np.ascontiguousarray(pixels))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device).float() / self._255

    def _sync(self) -> None:
        """Wait for the pipeline's card (nothing to wait for on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _letterbox_batch(self, images: Sequence[Optional[np.ndarray]]):
        size = self.pipe.cfg.det_input_size
        canvases, geoms = [], []
        for img in images:
            if img is None:
                canvases.append(np.full((size, size, 3), 114, np.uint8))
                geoms.append((1.0, 0.0, 0.0, 0, 0))
                continue
            canvas, r, (dw, dh) = letterbox_host(img, size)
            canvases.append(canvas)
            geoms.append((r, dw, dh, img.shape[1], img.shape[0]))
        return np.stack(canvases), geoms

    def _crop_rois(self, image: np.ndarray, boxes: np.ndarray) -> np.ndarray:
        """Host ROI crops, reference semantics: int-truncated slice +
        ``cv2.resize`` (``INTER_LINEAR``) of the uint8 crop to
        cls_input_size (e2e_optimize.py's no-PIL variant).  (N, c, c, 3)
        uint8."""
        import cv2

        c = self.pipe.cfg.cls_input_size
        crops = np.zeros((len(boxes), c, c, 3), np.uint8)
        xi1, yi1, xi2, yi2 = int_crop_coords(
            np.asarray(boxes, np.float32).reshape(-1, 4),
            image.shape[1],
            image.shape[0],
        )
        for i in range(len(boxes)):
            roi = image[yi1[i] : yi2[i], xi1[i] : xi2[i]]
            crops[i] = cv2.resize(roi, (c, c), interpolation=cv2.INTER_LINEAR)
        return crops

    def run_batch(
        self,
        paths: Sequence[str],
        conf_threshold: float,
        timings: Optional[PipelineMetrics] = None,
        eval_budget: bool = False,
    ) -> List[Dict[str, np.ndarray]]:
        """Run the two-stage pipeline over a batch of image paths
        (decode from disk + :meth:`run_images`)."""
        t0 = time.perf_counter()
        images = [self._read_image(p) for p in paths]
        decode_ms = (time.perf_counter() - t0) * 1e3
        if timings is not None:
            timings.t_postprocess += decode_ms
            timings.t_total += decode_ms
        return self.run_images(
            images, conf_threshold, timings=timings, eval_budget=eval_budget
        )

    def run_images(
        self,
        images: Sequence[Optional[np.ndarray]],
        conf_threshold: float,
        timings: Optional[PipelineMetrics] = None,
        eval_budget: bool = False,
    ) -> List[Dict[str, np.ndarray]]:
        """Run the two-stage pipeline over pre-decoded frames.

        Returns one result dict per image (None for an unreadable one):
        boxes (N, 4) xyxy original pixels, det_scores (N,), labels (N,)
        classifier argmax, cls_scores (N,).  Frames and crops stay in
        ``cfg.input_color`` order on the host; the pipeline flips "bgr" to
        RGB on the device.

        ``eval_budget=True`` is the mAP-pass configuration: the device stops
        at candidate decode and the exact unbounded greedy NMS runs on the
        host in *original-image space* — the reference's literal suppression
        order (conf filter -> un-letterbox -> clip -> per-class NMS,
        e2e.py:240-296) with no fixed-shape candidate or detection caps.
        The serving path (default) keeps NMS on the device (the NMS kernel
        on the card).
        """
        cfg = self.pipe.cfg
        t0 = time.perf_counter()
        canvases, geoms = self._letterbox_batch(images)
        canvas01 = self._to_unit(canvases)

        t1 = time.perf_counter()
        if eval_budget:
            cand = StageTimer.sync(self.pipe.detect_candidates(canvas01))
        else:
            det = StageTimer.sync(self.pipe.detect(canvas01, conf_threshold=conf_threshold))
        t2 = time.perf_counter()
        # each output to the host once per batch
        if eval_budget:
            cand_boxes, cand_scores, cand_cls = (x.cpu().numpy() for x in cand)
        else:
            det = {k: v.cpu().numpy() for k, v in det.items()}

        results = []
        all_crops = []
        for bi, (r, dw, dh, w, h) in enumerate(geoms):
            if images[bi] is None:
                results.append(None)
                continue
            if eval_budget:
                sel = cand_scores[bi] > conf_threshold
                boxes640 = cand_boxes[bi][sel]
                scores = cand_scores[bi][sel]
                cls_ids = cand_cls[bi][sel]
            else:
                valid = det["valid"][bi]
                boxes640 = det["boxes"][bi][valid]
                scores = det["scores"][bi][valid]
            boxes = (boxes640 - np.array([dw, dh, dw, dh])) / r
            boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
            boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
            if eval_budget and len(boxes):
                # exact per-class greedy NMS on the clipped original-space
                # boxes (reference per-class dispatch, e2e.py:280-296)
                keep_mask = np.zeros(len(boxes), bool)
                for c in np.unique(cls_ids):
                    idx = np.flatnonzero(cls_ids == c)
                    kept = nms_numpy_reference(
                        boxes[idx], scores[idx], cfg.nms.iou_threshold
                    )
                    keep_mask[idx[kept]] = True
                boxes, scores = boxes[keep_mask], scores[keep_mask]
                if cfg.nms.eval_max_detections:
                    order = np.argsort(-scores)[: cfg.nms.eval_max_detections]
                    boxes, scores = boxes[order], scores[order]
            # min-area filter in the reference's INT-cast crop geometry
            # (e2e.py:464-471) — the same integers _crop_rois slices with,
            # so a box survives here iff its crop exists there
            xi1, yi1, xi2, yi2 = int_crop_coords(boxes, w, h)
            keep = (xi2 - xi1) * (yi2 - yi1) >= cfg.nms.min_area
            boxes, scores = boxes[keep], scores[keep]
            results.append(
                {
                    "boxes": boxes.astype(np.float32),
                    "det_scores": scores.astype(np.float32),
                }
            )
            all_crops.append(self._crop_rois(images[bi], boxes))
        t3 = time.perf_counter()

        labels_flat, cls_scores_flat = self._classify_crops(all_crops)
        t4 = time.perf_counter()

        offset = 0
        for res in results:
            if res is None:
                continue
            n = len(res["boxes"])
            res["labels"] = labels_flat[offset : offset + n]
            res["cls_scores"] = cls_scores_flat[offset : offset + n]
            offset += n

        if timings is not None:
            timings.t_detection += (t2 - t1) * 1e3
            timings.t_roi_extract += (t3 - t2) * 1e3
            timings.t_classification += (t4 - t3) * 1e3
            timings.t_postprocess += (t1 - t0) * 1e3  # letterbox + upload
            timings.t_total += (t4 - t0) * 1e3
        return results

    def _classify_crops(self, all_crops: List[np.ndarray]):
        """uint8 crops -> (argmax labels int32, max probabilities float32):
        ``CLS_CHUNK`` crops per classifier call (zero-padded), the
        probabilities fetched to the host once."""
        if not all_crops or sum(len(c) for c in all_crops) == 0:
            return np.zeros(0, np.int32), np.zeros(0, np.float32)
        flat = np.concatenate(all_crops)
        cap = self.CLS_CHUNK
        n = len(flat)
        padded_n = int(np.ceil(n / cap) * cap)
        if padded_n != n:
            flat = np.concatenate(
                [flat, np.zeros((padded_n - n, *flat.shape[1:]), np.uint8)]
            )
        flat01 = self._to_unit(flat)
        probs = torch.cat(
            [self.pipe.classify(flat01[i : i + cap]) for i in range(0, padded_n, cap)]
        )
        probs = probs[:n].cpu().numpy()
        return probs.argmax(-1).astype(np.int32), probs.max(-1).astype(np.float32)

    # ------------------------------------------------------------------ #

    def _save_viz(
        self,
        viz_dir: str,
        path: str,
        img: np.ndarray,
        res: Dict[str, np.ndarray],
        gt_boxes: np.ndarray,
        conf: float,
    ) -> None:
        """Annotated prediction image (reference visualize_prediction,
        e2e.py:826-887): GT boxes blue, detections above ``conf`` green with
        classifier label + score, written under the frame's file name."""
        import cv2

        os.makedirs(viz_dir, exist_ok=True)
        canvas = img.copy()
        for b in gt_boxes:
            x1, y1, x2, y2 = (int(v) for v in b)
            cv2.rectangle(canvas, (x1, y1), (x2, y2), (255, 128, 0), 2)
        for i in range(len(res["boxes"])):
            if res["det_scores"][i] < conf:
                continue
            x1, y1, x2, y2 = (int(v) for v in res["boxes"][i])
            label = int(res["labels"][i]) if "labels" in res else -1
            name = self.class_names.get(label, str(label))
            cv2.rectangle(canvas, (x1, y1), (x2, y2), (0, 220, 0), 2)
            cv2.putText(
                canvas,
                f"{name} {res['det_scores'][i]:.2f}",
                (x1, max(y1 - 5, 12)),
                cv2.FONT_HERSHEY_SIMPLEX,
                0.5,
                (0, 220, 0),
                1,
            )
        cv2.imwrite(os.path.join(viz_dir, os.path.basename(path)), canvas)

    def _timed_fused_pass(
        self,
        batches: List[List[str]],
        trailing_real: int,
        conf: float,
    ) -> float:
        """Timed benchmark pass through the fused program; returns frames/s.

        Frames are pre-decoded in bounded memory windows (the reference
        times ``pipeline.run`` only, not imread — e2e.py:973) and pinned;
        within each window one ``run_fused`` per batch, all issued back to
        back (the upload of each batch on the stream before it) and waited
        for once per window, so the number reflects sustained throughput the
        way the serving path runs.  Mixed-resolution batches fall back to
        the staged path.
        """
        if not batches:
            return 0.0
        # decode in bounded windows sized from the first frame's bytes, so
        # decode stays out of the timed sections and memory stays bounded
        probe = self._read_image(batches[0][0])
        frame_bytes = int(probe.nbytes) if probe is not None else 640 * 640 * 3
        window_batches = max(
            1, (512 * 1024 * 1024) // max(1, len(batches[0]) * frame_bytes)
        )
        seen = set()
        total = 0
        dt = 0.0
        for w0 in range(0, len(batches), window_batches):
            window = batches[w0 : w0 + window_batches]
            prepared = []
            for i, batch in enumerate(window):
                gi = w0 + i
                real = trailing_real if gi == len(batches) - 1 else len(batch)
                imgs = [self._read_image(p) for p in batch]
                ok = all(im is not None for im in imgs) and (
                    len({im.shape for im in imgs}) == 1
                )
                frames = None
                if ok:
                    frames = torch.from_numpy(np.stack(imgs))
                    if self.device.type == "cuda":
                        frames = frames.pin_memory()
                prepared.append((frames, batch))
                total += real
            for frames, batch in prepared:
                if frames is not None and tuple(frames.shape) not in seen:
                    seen.add(tuple(frames.shape))
                    self.pipe.run_fused(frames.to(self.device), conf)  # warm-up
            self._sync()
            t0 = time.perf_counter()
            for frames, batch in prepared:
                if frames is not None:
                    self.pipe.run_fused(frames.to(self.device, non_blocking=True), conf)
                else:
                    self.run_batch(batch, conf)
            self._sync()
            dt += time.perf_counter() - t0
        return total / dt if dt > 0 else 0.0

    def evaluate_dataset(
        self,
        image_paths: Sequence[str],
        labels_dir: str,
        num_classes: int,
        yolo_conf: float = 0.001,
        benchmark_conf: float = 0.25,
        warmup: int = 2,
        viz_dir: Optional[str] = None,
        metrics_mode: str = "reference",
    ) -> Dict[str, object]:
        """Two-pass dataset evaluation (reference main loop e2e.py:1108-1139).

        ``metrics_mode``: ``"reference"`` (default) uses the reference-exact
        evaluator (evals/reference.py — AP closed at recall 1.0,
        class-agnostic matching, per-class best-F1 points) so the CSV rows
        are comparable to the reference's published numbers;
        ``"ultralytics"`` is the opt-in Ultralytics-contract evaluator
        (evals/map.py); ``"level0"`` the level-0 baseline's single-IoU
        greedy surface (evals/level0.py; its mAP columns are NaN).

        Returns the metric dict plus ``fps`` (benchmark-conf pass, end to
        end including host IO) and the stage timings of one staged batch.
        """
        if metrics_mode not in ("reference", "ultralytics", "level0"):
            raise ValueError(f"unknown metrics_mode: {metrics_mode!r}")
        cfg = self.pipe.cfg
        bs = cfg.batch_size
        batches = [
            list(image_paths[i : i + bs])
            for i in range(0, len(image_paths), bs)
        ]
        # pad the trailing batch to the batch size
        if batches and len(batches[-1]) < bs:
            batches[-1] += [batches[-1][-1]] * (bs - len(batches[-1]))
            trailing_real = len(image_paths) - bs * (len(batches) - 1)
        else:
            trailing_real = bs

        for _ in range(min(warmup, len(batches))):
            self.run_batch(batches[0], benchmark_conf)

        # PASS 1 — timed benchmark pass at benchmark_conf through the fused
        # program, the serving configuration the FPS number describes
        timings = PipelineMetrics()
        fps = self._timed_fused_pass(batches, trailing_real, benchmark_conf)
        # stage-level timings from one staged run (diagnostic, not the FPS)
        self.run_batch(batches[0], benchmark_conf, timings)

        # PASS 2 — low-conf mAP pass on the eval NMS budgets (the reference
        # evaluates unbounded at yolo_conf; the serving budget would clip
        # the PR-curve tail on dense scenes)
        all_preds, all_gts = [], []
        for i, batch in enumerate(batches):
            real = trailing_real if i == len(batches) - 1 else bs
            images = [self._read_image(p) for p in batch]
            results = self.run_images(images, yolo_conf, eval_budget=True)
            for p, img, res in zip(batch[:real], images[:real], results[:real]):
                h, w = (img.shape[0], img.shape[1]) if img is not None else (1, 1)
                label_path = os.path.join(
                    labels_dir,
                    os.path.splitext(os.path.basename(p))[0] + ".txt",
                )
                gt_boxes, gt_cls = parse_yolo_label(label_path, w, h)
                if metrics_mode in ("reference", "level0"):
                    # the reference evaluation consumes INT-truncated
                    # coordinates on both sides: GT via int() per corner
                    # (parse_yolo_label, e2e.py:151-154) and predictions
                    # via bbox=tuple(boxes[i].astype(int)) (run :525;
                    # level0: extract_predictions e2e_level0.py:148)
                    gt_boxes = np.trunc(gt_boxes.astype(np.float64)).astype(
                        np.float32
                    )
                all_gts.append((gt_boxes, gt_cls))
                if res is None:
                    all_preds.append(
                        (
                            np.zeros((0, 4), np.float32),
                            np.zeros(0, np.float32),
                            np.zeros(0, np.int32),
                        )
                    )
                else:
                    pb = res["boxes"]
                    if metrics_mode in ("reference", "level0"):
                        pb = np.trunc(pb)  # reference bbox astype(int)
                    all_preds.append((pb, res["det_scores"], res["labels"]))
                if viz_dir and img is not None and res is not None:
                    self._save_viz(
                        viz_dir, p, img, res, gt_boxes, benchmark_conf
                    )

        if metrics_mode == "reference":
            raw = evaluate_predictions_reference(all_preds, all_gts, num_classes)
            # the scalar surface write_results/_plot_metrics consume: the
            # CSV columns are means over GT-present classes of the per-class
            # best-F1 values (e2e.py:1159-1171); tp/fp/fn are summed over
            # present classes for the summary line
            present = np.asarray(raw["classes_present"])
            metrics = dict(raw)
            metrics["precision"] = raw["mean_precision"]
            metrics["recall"] = raw["mean_recall"]
            metrics["f1"] = raw["mean_f1"]
            metrics["tp"] = int(np.asarray(raw["tp"])[present].sum())
            metrics["fp"] = int(np.asarray(raw["fp"])[present].sum())
            metrics["fn"] = int(np.asarray(raw["fn"])[present].sum())
            metrics["ap50_per_class"] = {
                int(c): float(np.asarray(raw["ap50_per_class"])[c])
                for c in np.flatnonzero(present)
            }
            metrics["classes_present"] = np.flatnonzero(present).tolist()
        elif metrics_mode == "ultralytics":
            metrics = evaluate_predictions(all_preds, all_gts, num_classes)
        else:
            # the level-0 baseline defines no AP: the mAP columns carry NaN
            raw = evaluate_predictions_level0(all_preds, all_gts, num_classes)
            metrics = dict(raw)
            metrics["precision"] = raw["mean_precision"]
            metrics["recall"] = raw["mean_recall"]
            metrics["f1"] = raw["mean_f1"]
            metrics["tp"] = int(raw["tp"].sum())
            metrics["fp"] = int(raw["fp"].sum())
            metrics["fn"] = int(raw["fn"].sum())
            metrics["mAP50"] = float("nan")
            metrics["mAP50_95"] = float("nan")
            metrics["per_class"] = {
                c: {
                    "precision": float(raw["precision_per_class"][c]),
                    "recall": float(raw["recall_per_class"][c]),
                    "f1": float(raw["f1_per_class"][c]),
                    "tp": int(raw["tp"][c]),
                    "fp": int(raw["fp"][c]),
                    "fn": int(raw["fn"][c]),
                }
                for c in range(num_classes)
            }
        metrics["metrics_mode"] = metrics_mode
        metrics["fps"] = fps
        metrics["num_images"] = len(image_paths)
        # ``timings`` accumulated over exactly ONE staged diagnostic batch
        metrics["stage_ms_per_batch"] = {
            "detection": timings.t_detection,
            "roi_extract": timings.t_roi_extract,
            "classification": timings.t_classification,
            "host_io": timings.t_postprocess,
        }
        metrics.update(read_host_counters())
        return metrics


def write_results(
    output_dir: str,
    combo_name: str,
    detector_name: str,
    classifier_name: str,
    metrics: Dict[str, object],
    image_paths: Sequence[str],
    class_names: Optional[Dict[int, str]] = None,
) -> None:
    """Write the reference's three artifacts: append-mode
    ``comparison_summary.csv``, per-combo ``{name}_results.csv`` (per-class
    rows) and ``{name}_test_files.txt`` (e2e.py:1141-1185), plus the usage
    and stage CSVs and the metrics figure."""
    os.makedirs(output_dir, exist_ok=True)
    combo_dir = os.path.join(output_dir, combo_name)
    os.makedirs(combo_dir, exist_ok=True)

    summary = os.path.join(output_dir, "comparison_summary.csv")
    new_file = not os.path.exists(summary)
    with open(summary, "a", newline="") as f:
        w = csv.writer(f)
        if new_file:
            w.writerow(
                [
                    "model_combination",
                    "detector",
                    "classifier",
                    "num_test_images",
                    "mean_precision",
                    "mean_recall",
                    "mean_f1",
                    "fps",
                    "mAP50",
                    "mAP50-95",
                ]
            )
        w.writerow(
            [
                combo_name,
                detector_name,
                classifier_name,
                metrics.get("num_images", 0),
                metrics["precision"],
                metrics["recall"],
                metrics["f1"],
                metrics.get("fps", 0.0),
                metrics["mAP50"],
                metrics["mAP50_95"],
            ]
        )

    with open(
        os.path.join(combo_dir, f"{combo_name}_results.csv"), "w", newline=""
    ) as f:
        w = csv.writer(f)
        w.writerow(["class", "precision", "recall", "f1", "tp", "fp", "fn"])
        names = class_names or {}
        for c, row in sorted(metrics.get("per_class", {}).items()):
            w.writerow(
                [
                    names.get(c, str(c)),
                    row["precision"],
                    row["recall"],
                    row["f1"],
                    row["tp"],
                    row["fp"],
                    row["fn"],
                ]
            )

    with open(
        os.path.join(combo_dir, f"{combo_name}_test_files.txt"), "w"
    ) as f:
        for p in image_paths:
            f.write(os.path.basename(p) + "\n")

    # host counters + stage decomposition, consumed by the reporting CLI's
    # resource-utilisation and latency-breakdown figures (ref viz.py:99-283)
    with open(
        os.path.join(combo_dir, f"{combo_name}_usage.csv"), "w", newline=""
    ) as f:
        w = csv.writer(f)
        keys = ["cpu_percent", "memory_mb", "temperature_c"]
        w.writerow(keys)
        w.writerow([metrics.get(k, "") for k in keys])
    stage = metrics.get("stage_ms_per_batch") or {}
    if stage:
        with open(
            os.path.join(combo_dir, f"{combo_name}_stages.csv"),
            "w",
            newline="",
        ) as f:
            w = csv.writer(f)
            w.writerow(list(stage))
            w.writerow([f"{v:.4f}" for v in stage.values()])

    _plot_metrics(combo_dir, combo_name, metrics, class_names)


def _plot_metrics(
    combo_dir: str,
    combo_name: str,
    metrics: Dict[str, object],
    class_names: Optional[Dict[int, str]] = None,
) -> None:
    """Per-combination metrics figure (the reference's ``plot_metrics``
    output {name}_metrics.png — e2e.py:889-950): per-class P/R/F1 lines plus
    a summary panel.  Without matplotlib there is no figure."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return

    per_class = metrics.get("per_class", {})
    fig, axes = plt.subplots(1, 2, figsize=(12, 4.5))
    if per_class:
        names = class_names or {}
        labels = [names.get(c, str(c)) for c in sorted(per_class)]
        for key, color in (
            ("precision", "#4878a8"),
            ("recall", "#a85448"),
            ("f1", "#6aa84f"),
        ):
            axes[0].plot(
                labels,
                [per_class[c][key] for c in sorted(per_class)],
                marker="o",
                ms=3,
                lw=1,
                label=key,
                color=color,
            )
        axes[0].set_ylim(0, 1.05)
        axes[0].legend()
        axes[0].set_title("per-class P/R/F1 at best-F1 conf")
        axes[0].tick_params(axis="x", rotation=90, labelsize=6)
    summary_keys = ["precision", "recall", "f1", "mAP50", "mAP50_95"]
    axes[1].bar(
        summary_keys, [float(metrics[k]) for k in summary_keys], color="#4878a8"
    )
    axes[1].set_ylim(0, 1.05)
    axes[1].set_title(f"{combo_name} (fps {float(metrics.get('fps', 0)):.1f})")
    fig.tight_layout()
    fig.savefig(
        os.path.join(combo_dir, f"{combo_name}_metrics.png"), dpi=120
    )
    plt.close(fig)
