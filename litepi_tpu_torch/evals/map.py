"""Ultralytics-contract detection metrics: P / R / F1, mAP@0.5, mAP@0.5:0.95
(the port's copy of the JAX package's numpy oracle ``litepi_tpu/evals/map.py``,
names and arithmetic unchanged).

This is the **opt-in** evaluator (``--metrics ultralytics``).  It follows the
Ultralytics library's conventions, which differ from the reference evaluator
(e2e.py:656-824) in three deliberate ways: (a) the AP curve is closed at
``recall[-1] + 0.01`` (no linear bridge to recall 1.0), (b) IoU is
class-masked *before* greedy matching, (c) the operating point is one shared
best-mean-F1 confidence across classes.  For numbers comparable to the
reference's published CSVs use :mod:`litepi_tpu_torch.evals.reference` (the
default), which reproduces the reference semantics exactly and is
differentially tested against a transcription of its code path.

Host-side numpy: metric accumulation is IO-shaped, not FLOP-shaped — it does
not belong on the accelerator.  The per-image matcher is vectorised (no Python loop
over detections).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)


def box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU between xyxy boxes a (M, 4) and b (N, 4) -> (M, N)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-6)


def match_predictions(
    pred_boxes: np.ndarray,
    pred_cls: np.ndarray,
    gt_boxes: np.ndarray,
    gt_cls: np.ndarray,
    iou_thresholds: np.ndarray = IOU_THRESHOLDS,
) -> np.ndarray:
    """Greedy unique matching for one image.

    Returns ``correct`` (num_preds, num_thresholds) bool: prediction i is a
    TP at threshold t iff it matches a distinct same-class gt with
    IoU >= t.  Matches are assigned best-IoU-first with both the prediction
    and the gt consumed (the Ultralytics contract the reference mirrors).
    """
    npr, nt = pred_boxes.shape[0], len(iou_thresholds)
    correct = np.zeros((npr, nt), dtype=bool)
    if npr == 0 or gt_boxes.shape[0] == 0:
        return correct
    iou = box_iou_np(gt_boxes, pred_boxes)  # (ngt, npr)
    cls_ok = gt_cls[:, None] == pred_cls[None, :]
    iou = np.where(cls_ok, iou, 0.0)
    for t_idx, thr in enumerate(iou_thresholds):
        gi, pi = np.nonzero(iou >= thr)
        if gi.size == 0:
            continue
        order = np.argsort(-iou[gi, pi])
        gi, pi = gi[order], pi[order]
        # unique prediction, then unique gt, keeping highest-IoU pairs
        pi_first = np.unique(pi, return_index=True)[1]
        gi, pi = gi[np.sort(pi_first)], pi[np.sort(pi_first)]
        gi_first = np.unique(gi, return_index=True)[1]
        gi, pi = gi[np.sort(gi_first)], pi[np.sort(gi_first)]
        correct[pi, t_idx] = True
    return correct


def _ap_101(recall: np.ndarray, precision: np.ndarray) -> float:
    """101-point interpolated average precision (Ultralytics compute_ap:
    close the curve at recall[-1]+0.01 — precision is zero past the last
    achieved recall, not linearly bridged to 1.0)."""
    mrec = np.concatenate(([0.0], recall, [recall[-1] + 0.01]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0.0, 1.0, 101)
    return float(np.trapezoid(np.interp(x, mrec, mpre), x))


def evaluate_predictions(
    all_preds: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    all_gts: Sequence[Tuple[np.ndarray, np.ndarray]],
    num_classes: int,
) -> Dict[str, object]:
    """Dataset-level metrics.

    all_preds: per image (boxes (N,4), scores (N,), cls (N,)).
    all_gts:   per image (boxes (M,4), cls (M,)).

    Returns the reference's metric dict surface (SURVEY §1 L5): precision,
    recall, f1, tp/fp/fn at best-F1 conf, mAP50, mAP50_95, ap50_per_class,
    classes_present.
    """
    correct_list: List[np.ndarray] = []
    conf_list: List[np.ndarray] = []
    pcls_list: List[np.ndarray] = []
    target_cls: List[np.ndarray] = []
    for (pb, ps, pc), (gb, gc) in zip(all_preds, all_gts):
        correct_list.append(match_predictions(pb, pc, gb, gc))
        conf_list.append(ps)
        pcls_list.append(pc)
        target_cls.append(gc)

    correct = (
        np.concatenate(correct_list)
        if correct_list
        else np.zeros((0, len(IOU_THRESHOLDS)), bool)
    )
    conf = np.concatenate(conf_list) if conf_list else np.zeros(0)
    pred_cls = np.concatenate(pcls_list) if pcls_list else np.zeros(0, np.int32)
    tcls = np.concatenate(target_cls) if target_cls else np.zeros(0, np.int32)

    order = np.argsort(-conf)
    correct, conf, pred_cls = correct[order], conf[order], pred_cls[order]

    classes_present = np.unique(tcls).astype(int)
    ap = np.zeros((num_classes, len(IOU_THRESHOLDS)))
    p_at_best = np.zeros(num_classes)
    r_at_best = np.zeros(num_classes)
    f1_curves = []

    eps = 1e-16
    for c in classes_present:
        sel = pred_cls == c
        n_gt = int((tcls == c).sum())
        n_p = int(sel.sum())
        if n_p == 0 or n_gt == 0:
            continue
        tp_cum = np.cumsum(correct[sel], axis=0)  # (n_p, T)
        fp_cum = np.cumsum(~correct[sel], axis=0)
        recall = tp_cum / (n_gt + eps)
        precision = tp_cum / (tp_cum + fp_cum + eps)
        for t in range(len(IOU_THRESHOLDS)):
            ap[c, t] = _ap_101(recall[:, t], precision[:, t])
        # P/R/F1 curve at IoU 0.5 over confidence for the operating point
        f1 = 2 * precision[:, 0] * recall[:, 0] / (
            precision[:, 0] + recall[:, 0] + eps
        )
        f1_curves.append((conf[sel], precision[:, 0], recall[:, 0], f1, c))

    # operating point: the confidence maximising mean F1 (reference picks the
    # best-F1 point on the PR curve, e2e.py:762-799)
    precision_v = recall_v = f1_v = 0.0
    tp_v = fp_v = fn_v = 0
    per_class: Dict[int, Dict[str, float]] = {}
    if f1_curves:
        # evaluate mean-F1 over a shared confidence grid
        grid = np.linspace(0, 1, 101)
        mean_f1 = np.zeros_like(grid)
        for confs, p_curve, r_curve, f1_curve, _ in f1_curves:
            # curves are indexed by detections sorted desc by conf; at grid
            # threshold g, the operating index is the last det with conf >= g
            idx = np.searchsorted(-confs, -grid, side="right") - 1
            valid = idx >= 0
            vals = np.where(valid, f1_curve[np.clip(idx, 0, None)], 0.0)
            mean_f1 += vals / len(f1_curves)
        best_g = grid[int(np.argmax(mean_f1))]
        for confs, p_curve, r_curve, f1_curve, c in f1_curves:
            idx = np.searchsorted(-confs, -best_g, side="right") - 1
            if idx >= 0:
                p_at_best[c] = p_curve[idx]
                r_at_best[c] = r_curve[idx]
        precision_v = float(p_at_best[classes_present].mean())
        recall_v = float(r_at_best[classes_present].mean())
        f1_v = 2 * precision_v * recall_v / (precision_v + recall_v + eps)
        keep = conf >= best_g
        tp_v = int(correct[keep, 0].sum())
        fp_v = int((~correct[keep, 0]).sum())
        fn_v = int(len(tcls) - tp_v)
        # per-class confusion at the operating point (the reference's
        # per-combination results CSV rows: class,precision,recall,f1,tp,fp,fn)
        for c in classes_present:
            sel = (pred_cls == c) & keep
            n_gt_c = int((tcls == c).sum())
            tp_c = int(correct[sel, 0].sum())
            fp_c = int(sel.sum()) - tp_c
            fn_c = n_gt_c - tp_c
            p_c = tp_c / (tp_c + fp_c + eps)
            r_c = tp_c / (n_gt_c + eps)
            per_class[int(c)] = {
                "precision": p_c,
                "recall": r_c,
                "f1": 2 * p_c * r_c / (p_c + r_c + eps),
                "tp": tp_c,
                "fp": fp_c,
                "fn": fn_c,
            }

    present = classes_present
    map50 = float(ap[present, 0].mean()) if present.size else 0.0
    map50_95 = float(ap[present].mean()) if present.size else 0.0

    return {
        "precision": precision_v,
        "recall": recall_v,
        "f1": f1_v,
        "tp": tp_v,
        "fp": fp_v,
        "fn": fn_v,
        "mAP50": map50,
        "mAP50_95": map50_95,
        "ap50_per_class": {int(c): float(ap[c, 0]) for c in present},
        "classes_present": present.tolist(),
        "per_class": per_class,
        "best_conf": float(best_g) if f1_curves else 0.0,
    }
