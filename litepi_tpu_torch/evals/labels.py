"""YOLO-format label parsing and dataset sampling helpers (the port's copy
of the JAX package's ``litepi_tpu/evals/labels.py``, names unchanged).

Mirrors the reference's host-side helpers: ``parse_yolo_label``
(e2e.py:137-157 — normalized ``class cx cy w h`` lines -> absolute xyxy),
``load_class_names`` (e2e.py:160-176 — ``idx2label.json`` dict or plaintext,
one name per line) and ``sample_images`` (e2e.py:179-186 — seeded
``random.sample`` over the sorted file list, so runs are reproducible).
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def parse_yolo_label(
    label_path: str, img_w: int, img_h: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Parse one YOLO label file into (boxes_xyxy (N, 4) float32 absolute
    pixels, class_ids (N,) int32).  Missing files mean a negative image
    (the reference's test-subset script writes empty label files for those —
    data_split.ipynb cell 0)."""
    boxes: List[List[float]] = []
    classes: List[int] = []
    if os.path.exists(label_path):
        with open(label_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 5:
                    continue
                cls = int(float(parts[0]))
                cx, cy, w, h = (float(p) for p in parts[1:5])
                x1 = (cx - w / 2) * img_w
                y1 = (cy - h / 2) * img_h
                x2 = (cx + w / 2) * img_w
                y2 = (cy + h / 2) * img_h
                boxes.append([x1, y1, x2, y2])
                classes.append(cls)
    return (
        np.asarray(boxes, dtype=np.float32).reshape(-1, 4),
        np.asarray(classes, dtype=np.int32),
    )


def load_class_names(path: Optional[str]) -> Optional[Dict[int, str]]:
    """Load class-index -> name mapping from an ``idx2label.json`` dict or a
    plaintext file (one name per line), as the reference accepts both."""
    if path is None:
        return None
    if path.endswith(".json"):
        with open(path) as f:
            raw = json.load(f)
        return {int(k): str(v) for k, v in raw.items()}
    with open(path) as f:
        return {i: line.strip() for i, line in enumerate(f) if line.strip()}


def sample_images(
    image_dir: str, num_samples: Optional[int] = None, seed: int = 42
) -> List[str]:
    """Deterministic image sampling: sorted listing + seeded random.sample
    (the reference's reproducibility contract, e2e.py:179-186)."""
    files = sorted(
        f
        for f in os.listdir(image_dir)
        if f.lower().endswith(IMAGE_EXTENSIONS)
    )
    if num_samples is not None and num_samples < len(files):
        rng = random.Random(seed)
        files = sorted(rng.sample(files, num_samples))
    return [os.path.join(image_dir, f) for f in files]
