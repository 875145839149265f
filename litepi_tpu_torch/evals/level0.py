"""The reference's *simple* single-IoU greedy evaluator (the port's copy of
the JAX package's numpy oracle ``litepi_tpu/evals/level0.py``, names and
arithmetic unchanged).

``e2e_level0.py`` (the Ultralytics-direct level-0 baseline) reports a
deliberately simpler metric surface than the mAP evaluators: one IoU
threshold, greedy first-come matching in prediction order, class-agnostic
box matching with classification credited separately
(reference: e2e_level0.py:201-261, calculate_iou :186-198).  Exposed as the
``--metrics level0`` mode of the e2e CLI.

Semantics pinned by the transcription differential
(tests/test_level0_evals.py):

* predictions are consumed IN LIST ORDER (no score sort);
* each prediction takes the highest-IoU *unmatched* ground truth of ANY
  class (strict ``iou > best`` keeps the first GT on ties);
* a matched pair with agreeing class is a TP of that class; a disagreeing
  pair is an FP of the predicted class AND an FN of the GT class (the GT
  is still consumed);
* unmatched predictions are FPs, unmatched GTs are FNs;
* per-class P/R/F1 with zero-division -> 0; scalar summaries are means
  over ALL ``num_classes`` entries (absent classes count as zeros —
  exactly what the reference's ``np.mean(metrics['precision'])`` does,
  e2e_level0.py:607-633).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

Preds = Tuple[np.ndarray, np.ndarray, np.ndarray]  # boxes, scores, labels
Gts = Tuple[np.ndarray, np.ndarray]  # boxes, classes


def _iou_one_many(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """calculate_iou (e2e_level0.py:186-198) vectorised over the GT side:
    plain intersection-over-union, union<=0 -> 0, no epsilon."""
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(0, x2 - x1) * np.maximum(0, y2 - y1)
    area_a = (box[2] - box[0]) * (box[3] - box[1])
    area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = area_a + area_b - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def evaluate_predictions_level0(
    all_preds: Sequence[Preds],
    all_gts: Sequence[Gts],
    num_classes: int,
    iou_threshold: float = 0.5,
) -> Dict[str, object]:
    """Accumulate the level-0 counters over a dataset and derive the
    per-class and mean metrics (e2e_level0.py:201-261)."""
    tp = np.zeros(num_classes)
    fp = np.zeros(num_classes)
    fn = np.zeros(num_classes)

    for (boxes, _scores, labels), (gt_boxes, gt_cls) in zip(all_preds, all_gts):
        gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
        gt_cls = np.asarray(gt_cls, np.int64).reshape(-1)
        matched = np.zeros(len(gt_boxes), bool)
        for pi in range(len(boxes)):
            pred_cls = int(labels[pi])
            best_iou, best_gt = 0.0, -1
            if len(gt_boxes):
                iou = _iou_one_many(np.asarray(boxes[pi], np.float64), gt_boxes)
                iou = np.where(matched, -1.0, iou)
                # strict > with a 0 floor: ties keep the FIRST gt, and an
                # IoU-0 overlap never matches (reference best_iou starts 0)
                best_gt = int(np.argmax(iou))
                best_iou = float(iou[best_gt])
                if best_iou <= 0.0:
                    best_gt = -1
            if best_iou >= iou_threshold and best_gt >= 0:
                g = int(gt_cls[best_gt])
                matched[best_gt] = True
                if pred_cls == g:
                    tp[pred_cls] += 1
                else:
                    fp[pred_cls] += 1
                    fn[g] += 1
            else:
                fp[pred_cls] += 1
        for gi in range(len(gt_boxes)):
            if not matched[gi]:
                fn[int(gt_cls[gi])] += 1

    precision = np.divide(
        tp, tp + fp, out=np.zeros_like(tp), where=(tp + fp) != 0
    )
    recall = np.divide(tp, tp + fn, out=np.zeros_like(tp), where=(tp + fn) != 0)
    f1 = np.divide(
        2 * precision * recall,
        precision + recall,
        out=np.zeros_like(precision),
        where=(precision + recall) != 0,
    )
    return {
        "precision_per_class": precision,
        "recall_per_class": recall,
        "f1_per_class": f1,
        "tp": tp,
        "fp": fp,
        "fn": fn,
        # summary means over ALL classes (e2e_level0.py:607)
        "mean_precision": float(np.mean(precision)),
        "mean_recall": float(np.mean(recall)),
        "mean_f1": float(np.mean(f1)),
    }
