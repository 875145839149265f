"""Dataset integrity audit of the PyTorch port (the JAX package's
``data/audit.py``, numpy and cv2 only) — the reference's pre-training
pairing checks as a reusable tool (reference: train-yolo-custom-tt100k.ipynb cell 6 and
revision-ablation-study.ipynb cell 3 audit image/label pairing and label
sanity before every run).

Checks: image/label pairing (unlabelled images are *negatives*, allowed by
the reference's convention; orphan labels are errors), image readability,
label-line syntax (5 numeric fields), coordinate ranges (normalised cxcywh
in [0, 1], positive extents), class-id range, plus a class histogram and box
statistics.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from litepi_tpu_torch.evals.labels import IMAGE_EXTENSIONS


def audit_dataset(
    images_dir: str,
    labels_dir: str,
    num_classes: Optional[int] = None,
    check_readable: bool = True,
) -> Dict[str, object]:
    """Audit a YOLO-format dataset; returns a report dict (see keys below)."""
    images = {
        os.path.splitext(f)[0]: os.path.join(images_dir, f)
        for f in sorted(os.listdir(images_dir))
        if os.path.splitext(f)[1].lower() in IMAGE_EXTENSIONS
    }
    labels = {
        os.path.splitext(f)[0]: os.path.join(labels_dir, f)
        for f in sorted(os.listdir(labels_dir))
        if f.endswith(".txt")
    }

    negatives = sorted(set(images) - set(labels))
    orphan_labels = sorted(set(labels) - set(images))

    unreadable: List[str] = []
    if check_readable:
        import cv2

        for stem, path in images.items():
            if cv2.imread(path) is None:
                unreadable.append(path)

    malformed: List[str] = []
    out_of_range: List[str] = []
    bad_class: List[str] = []
    class_counts: Dict[int, int] = {}
    widths, heights = [], []
    for stem in sorted(set(labels) & set(images)):
        with open(labels[stem]) as f:
            for ln, line in enumerate(f, 1):
                parts = line.split()
                if not parts:
                    continue  # blank line in a label file is tolerated
                where = f"{labels[stem]}:{ln}"
                if len(parts) != 5:
                    malformed.append(where)
                    continue
                try:
                    cls = int(float(parts[0]))
                    cx, cy, w, h = (float(v) for v in parts[1:])
                except ValueError:
                    malformed.append(where)
                    continue
                if not (
                    0.0 <= cx <= 1.0
                    and 0.0 <= cy <= 1.0
                    and 0.0 < w <= 1.0
                    and 0.0 < h <= 1.0
                ):
                    out_of_range.append(where)
                if cls < 0 or (num_classes is not None and cls >= num_classes):
                    bad_class.append(where)
                class_counts[cls] = class_counts.get(cls, 0) + 1
                widths.append(w)
                heights.append(h)

    n_boxes = len(widths)
    report: Dict[str, object] = {
        "num_images": len(images),
        "num_label_files": len(labels),
        "num_negatives": len(negatives),
        "negatives": negatives[:20],
        "orphan_labels": orphan_labels,
        "unreadable_images": unreadable,
        "malformed_lines": malformed,
        "out_of_range_lines": out_of_range,
        "bad_class_lines": bad_class,
        "num_boxes": n_boxes,
        "class_counts": dict(sorted(class_counts.items())),
        "box_w_mean": float(np.mean(widths)) if n_boxes else 0.0,
        "box_h_mean": float(np.mean(heights)) if n_boxes else 0.0,
        "ok": not (orphan_labels or unreadable or malformed
                   or out_of_range or bad_class),
    }
    return report


def format_report(report: Dict[str, object]) -> str:
    lines = [
        f"images: {report['num_images']}  label files: "
        f"{report['num_label_files']}  boxes: {report['num_boxes']}",
        f"negatives (image without label, allowed): "
        f"{report['num_negatives']}",
    ]
    for key, label in (
        ("orphan_labels", "ORPHAN LABELS (no image)"),
        ("unreadable_images", "UNREADABLE IMAGES"),
        ("malformed_lines", "MALFORMED LABEL LINES"),
        ("out_of_range_lines", "OUT-OF-RANGE COORDS"),
        ("bad_class_lines", "BAD CLASS IDS"),
    ):
        vals = report[key]
        if vals:
            lines.append(f"{label}: {len(vals)}")
            lines.extend(f"  {v}" for v in list(vals)[:10])
    counts = report["class_counts"]
    if counts:
        lines.append(
            "class histogram: "
            + " ".join(f"{c}:{n}" for c, n in counts.items())
        )
        lines.append(
            f"box size (normalised) mean w={report['box_w_mean']:.4f} "
            f"h={report['box_h_mean']:.4f}"
        )
    lines.append("OK" if report["ok"] else "PROBLEMS FOUND")
    return "\n".join(lines)
