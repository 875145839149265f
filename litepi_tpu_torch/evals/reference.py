"""Reference-exact detection metrics (the port's copy of the JAX package's
numpy oracle ``litepi_tpu/evals/reference.py``, names and arithmetic
unchanged; tests/test_torch_evals.py holds the two equal).

Reproduces the *literal* semantics of the reference evaluator
(the reference repo's ``src/tt100k/pipeline/e2e.py:656-824``) so that every
``comparison_summary.csv`` number this framework produces is directly
comparable to the reference's published rows.  Three semantics differ from
the Ultralytics-style evaluator in :mod:`litepi_tpu_torch.evals.map` (kept as an
opt-in mode):

1. **AP curve closure** — ``compute_ap`` bridges the PR curve to recall 1.0
   (``mrec = [0, recall..., 1.0]``, e2e.py:680-687), linearly interpolating
   precision between the last achieved recall and 1.0, instead of zeroing
   precision past ``recall[-1] + 0.01`` (the Ultralytics sentinel).  On a
   half-recall / full-precision curve this is 0.75 vs ~0.505.
2. **Class-agnostic matching with post-hoc class check** — the IoU matrix is
   built over *all* predictions vs *all* GTs; unique assignment (best-IoU
   pred-dedup then gt-dedup via ``np.unique`` first-occurrence) happens
   before classes are compared; a wrong-class match consumes both the
   prediction and the GT (e2e.py:714-726).
3. **Per-class independent best-F1 operating points** — each class picks its
   own argmax-F1 confidence index on its IoU-0.5 PR curve (e2e.py:790-798);
   the CLI's ``mean_precision``/``mean_recall``/``mean_f1`` columns are means
   of those per-class values over GT-present classes (e2e.py:1159-1171).

Matching quirk preserved deliberately: after the descending-IoU sort, the
pred-dedup (``np.unique(col0, return_index=True)``) reorders surviving rows
by ascending prediction index, so the subsequent gt-dedup keeps, per GT, the
*lowest-prediction-index* pair rather than the highest-IoU one.  This is the
reference's (and Ultralytics') exact behaviour and can change TP sets on
overlapping boxes — parity requires it.

Host-side numpy (metric accumulation is IO-shaped, not FLOP-shaped).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)


def _box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU, xyxy, eps 1e-7 on the union (e2e.py:663-676)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-7)


def compute_ap_reference(recall: np.ndarray, precision: np.ndarray) -> float:
    """101-point interpolated AP with the curve closed at recall 1.0
    (e2e.py:680-687): precision decays linearly from its last achieved value
    to 0 at recall 1.0 via ``np.interp`` over the monotone envelope."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0.0, 1.0, 101)
    return float(np.trapezoid(np.interp(x, mrec, mpre), x))


def match_predictions_reference(
    pred_boxes: np.ndarray,
    pred_cls: np.ndarray,
    gt_boxes: np.ndarray,
    gt_cls: np.ndarray,
    iou_thresholds: np.ndarray = IOU_THRESHOLDS,
) -> np.ndarray:
    """One image's ``correct`` matrix (num_preds, num_thresholds), matching
    class-agnostically then checking class per assigned pair (e2e.py:713-727).
    """
    npr = pred_boxes.shape[0]
    correct = np.zeros((npr, len(iou_thresholds)), dtype=bool)
    if npr == 0 or gt_boxes.shape[0] == 0:
        return correct
    iou = _box_iou(pred_boxes, gt_boxes)  # (npred, ngt) — class-agnostic
    for t_idx, thr in enumerate(iou_thresholds):
        pi, gi = np.nonzero(iou >= thr)
        if pi.size == 0:
            continue
        pair_iou = iou[pi, gi]
        if pi.size > 1:
            # best-IoU first, then first-occurrence dedup by pred and by gt.
            # np.unique reorders by ascending index value — preserved quirk
            # (see module docstring).
            order = pair_iou.argsort()[::-1]
            pi, gi, pair_iou = pi[order], gi[order], pair_iou[order]
            keep_p = np.unique(pi, return_index=True)[1]
            pi, gi = pi[keep_p], gi[keep_p]
            keep_g = np.unique(gi, return_index=True)[1]
            pi, gi = pi[keep_g], gi[keep_g]
        same = pred_cls[pi] == gt_cls[gi]
        correct[pi[same], t_idx] = True
    return correct


def evaluate_predictions_reference(
    all_preds: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    all_gts: Sequence[Tuple[np.ndarray, np.ndarray]],
    num_classes: int,
    iou_thresholds: np.ndarray = IOU_THRESHOLDS,
) -> Dict[str, object]:
    """Dataset-level metrics with the reference's exact semantics + surface.

    all_preds: per image (boxes (N,4) xyxy, scores (N,), cls (N,)).
    all_gts:   per image (boxes (M,4) xyxy, cls (M,)).

    Returns per-class arrays ``precision/recall/f1/tp/fp/fn`` (num_classes,)
    at each class's own best-F1 point, ``mAP50``/``mAP50_95`` averaged over
    GT-present classes only, ``ap50_per_class``, ``classes_present`` (bool
    array), plus the scalar means the reference CLI writes to
    ``comparison_summary.csv`` (``mean_precision/mean_recall/mean_f1``,
    e2e.py:1159-1171) and the scalar aliases the rest of this package uses.
    """
    nt_thr = len(iou_thresholds)
    correct_list: List[np.ndarray] = []
    conf_list: List[np.ndarray] = []
    pcls_list: List[np.ndarray] = []
    tcls_list: List[np.ndarray] = []
    for (pb, ps, pc), (gb, gc) in zip(all_preds, all_gts):
        pb, ps = np.asarray(pb, np.float64), np.asarray(ps, np.float64)
        pc, gc = np.asarray(pc), np.asarray(gc)
        gb = np.asarray(gb, np.float64)
        if pb.shape[0] == 0:
            # reference (e2e.py:691-697): images with no preds contribute
            # their GT classes (for nt counts) only when GTs exist; an empty
            # image contributes nothing at all.
            if gc.shape[0] > 0:
                correct_list.append(np.zeros((0, nt_thr), dtype=bool))
                conf_list.append(np.zeros(0))
                pcls_list.append(np.zeros(0))
                tcls_list.append(gc)
            continue
        correct_list.append(
            match_predictions_reference(pb, pc, gb, gc, iou_thresholds)
        )
        conf_list.append(ps)
        pcls_list.append(pc)
        tcls_list.append(gc)

    zeros = np.zeros(num_classes)
    if not correct_list:
        return {
            "precision": zeros.copy(), "recall": zeros.copy(),
            "f1": zeros.copy(), "tp": zeros.copy(), "fp": zeros.copy(),
            "fn": zeros.copy(), "mAP50": 0.0, "mAP50_95": 0.0,
            "ap50_per_class": zeros.copy(),
            "classes_present": np.zeros(num_classes, dtype=bool),
            "mean_precision": 0.0, "mean_recall": 0.0, "mean_f1": 0.0,
            "per_class": {}, "best_conf": 0.0,
        }

    tp_all = np.concatenate(correct_list, 0)
    conf_all = np.concatenate(conf_list, 0)
    pred_cls_all = np.concatenate(pcls_list, 0)
    target_cls_all = (
        np.concatenate(tcls_list, 0) if tcls_list else np.zeros(0)
    )

    order = np.argsort(-conf_all)
    tp_all, conf_all = tp_all[order], conf_all[order]
    pred_cls_all = pred_cls_all[order]

    unique_classes, nt = np.unique(target_cls_all, return_counts=True)
    nt_dict = dict(zip(unique_classes, nt))

    ap50 = zeros.copy()
    ap50_95 = zeros.copy()
    p_best, r_best, f1_best = zeros.copy(), zeros.copy(), zeros.copy()
    tp_count, fp_count, fn_count = zeros.copy(), zeros.copy(), zeros.copy()
    best_conf = zeros.copy()
    eps = 1e-16

    for c in range(num_classes):
        n_gt = nt_dict.get(c, 0)
        i_cls = pred_cls_all == c
        n_p = int(i_cls.sum())
        if n_p == 0 and n_gt == 0:
            continue
        if n_p == 0 or n_gt == 0:
            fn_count[c] = n_gt
            continue

        tpc = tp_all[i_cls].cumsum(0)
        fpc = (1 - tp_all[i_cls]).cumsum(0)
        rec = tpc / (n_gt + eps)
        prec = tpc / (tpc + fpc + eps)

        ap_per_iou = [
            compute_ap_reference(rec[:, j], prec[:, j])
            for j in range(nt_thr)
        ]
        ap50[c] = ap_per_iou[0]
        ap50_95[c] = float(np.mean(ap_per_iou))

        # per-class independent best-F1 operating point (e2e.py:790-798)
        f1_curve = 2 * prec[:, 0] * rec[:, 0] / (prec[:, 0] + rec[:, 0] + eps)
        best_idx = int(np.argmax(f1_curve))
        p_best[c] = prec[best_idx, 0]
        r_best[c] = rec[best_idx, 0]
        f1_best[c] = f1_curve[best_idx]
        tp_count[c] = tpc[best_idx, 0]
        fp_count[c] = fpc[best_idx, 0]
        fn_count[c] = n_gt - tp_count[c]
        best_conf[c] = conf_all[i_cls][best_idx]

    present_idx = unique_classes.astype(int)
    present_mask = np.isin(np.arange(num_classes), unique_classes)
    if present_idx.size > 0:
        map50 = float(np.mean(ap50[present_idx]))
        map50_95 = float(np.mean(ap50_95[present_idx]))
        mean_p = float(np.mean(p_best[present_mask]))
        mean_r = float(np.mean(r_best[present_mask]))
        mean_f1 = float(np.mean(f1_best[present_mask]))
    else:
        map50 = map50_95 = mean_p = mean_r = mean_f1 = 0.0

    per_class = {
        int(c): {
            "precision": float(p_best[c]), "recall": float(r_best[c]),
            "f1": float(f1_best[c]), "tp": int(tp_count[c]),
            "fp": int(fp_count[c]), "fn": int(fn_count[c]),
        }
        for c in present_idx
    }

    return {
        "precision": p_best, "recall": r_best, "f1": f1_best,
        "tp": tp_count, "fp": fp_count, "fn": fn_count,
        "mAP50": map50, "mAP50_95": map50_95,
        "ap50_per_class": ap50,
        "classes_present": present_mask,
        # CSV-column scalars (means over GT-present classes, e2e.py:1159-1171)
        "mean_precision": mean_p, "mean_recall": mean_r, "mean_f1": mean_f1,
        "per_class": per_class,
        "best_conf": float(np.max(best_conf)) if present_idx.size else 0.0,
    }
