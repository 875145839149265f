"""Host-side training augmentations (the port's copy of the JAX package's
``litepi_tpu/data/augment.py``, names and draws unchanged).

The reference's recipe: mosaic 0.7, scale 0.5, copy_paste 0.05, hsv_h .015
/ hsv_s .7 / hsv_v .4, fliplr 0.5 for the detector; ColorJitter and a
MixUp (alpha .4) / CutMix (alpha 1.0) collate at p=0.7 for the classifier.
numpy and cv2 on the host: with the same ``np.random.Generator`` every
function draws the same numbers in the same order as the JAX package's, so
its output is equal bit for bit (``tests/test_torch_train_data.py``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def hsv_augment(
    img: np.ndarray,
    rng: np.random.Generator,
    h_gain: float = 0.015,
    s_gain: float = 0.7,
    v_gain: float = 0.4,
) -> np.ndarray:
    """Random HSV jitter (Ultralytics augment_hsv semantics)."""
    import cv2

    r = rng.uniform(-1, 1, 3) * [h_gain, s_gain, v_gain] + 1
    hue, sat, val = cv2.split(cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    x = np.arange(0, 256, dtype=r.dtype)
    lut_hue = ((x * r[0]) % 180).astype(np.uint8)
    lut_sat = np.clip(x * r[1], 0, 255).astype(np.uint8)
    lut_val = np.clip(x * r[2], 0, 255).astype(np.uint8)
    out = cv2.merge(
        (cv2.LUT(hue, lut_hue), cv2.LUT(sat, lut_sat), cv2.LUT(val, lut_val))
    )
    return cv2.cvtColor(out, cv2.COLOR_HSV2BGR)


def random_flip_lr(
    img: np.ndarray,
    boxes: np.ndarray,
    rng: np.random.Generator,
    p: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Horizontal flip with box remap (xyxy absolute)."""
    if rng.uniform() < p:
        w = img.shape[1]
        img = img[:, ::-1].copy()
        boxes = boxes.copy()
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    return img, boxes


def random_scale_shift(
    img: np.ndarray,
    boxes: np.ndarray,
    rng: np.random.Generator,
    scale: float = 0.5,
    out_size: int = 640,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random-resized placement onto a square canvas: combines the
    reference recipe's ``scale=0.5`` jitter with letterbox geometry."""
    import cv2

    h, w = img.shape[:2]
    s = rng.uniform(1 - scale, 1 + scale) * min(out_size / h, out_size / w)
    new_w, new_h = max(int(w * s), 1), max(int(h * s), 1)
    resized = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    canvas = np.full((out_size, out_size, 3), 114, np.uint8)
    dx = int(rng.uniform(0, max(out_size - new_w, 1)))
    dy = int(rng.uniform(0, max(out_size - new_h, 1)))
    w_c = min(new_w, out_size - dx)
    h_c = min(new_h, out_size - dy)
    canvas[dy : dy + h_c, dx : dx + w_c] = resized[:h_c, :w_c]
    out_boxes = boxes * s + np.array([dx, dy, dx, dy], np.float32)
    out_boxes[:, [0, 2]] = out_boxes[:, [0, 2]].clip(0, out_size)
    out_boxes[:, [1, 3]] = out_boxes[:, [1, 3]].clip(0, out_size)
    return canvas, out_boxes.astype(np.float32)


def mosaic4(
    samples: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    rng: np.random.Generator,
    out_size: int = 640,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """4-image mosaic: each sample fills one quadrant around a jittered
    centre (Ultralytics Mosaic semantics; the reference trains with
    mosaic=0.7).  ``samples``: 4x (img, boxes xyxy abs, classes)."""
    import cv2

    assert len(samples) == 4
    cx = int(rng.uniform(out_size * 0.25, out_size * 0.75))
    cy = int(rng.uniform(out_size * 0.25, out_size * 0.75))
    canvas = np.full((out_size, out_size, 3), 114, np.uint8)
    all_boxes, all_cls = [], []
    quads = [
        (0, 0, cx, cy),
        (cx, 0, out_size, cy),
        (0, cy, cx, out_size),
        (cx, cy, out_size, out_size),
    ]
    for (x1, y1, x2, y2), (img, boxes, cls) in zip(quads, samples):
        qw, qh = x2 - x1, y2 - y1
        if qw <= 0 or qh <= 0:
            continue
        h, w = img.shape[:2]
        s = max(qw / w, qh / h)
        rw, rh = max(int(w * s), qw), max(int(h * s), qh)
        resized = cv2.resize(img, (rw, rh), interpolation=cv2.INTER_LINEAR)
        canvas[y1:y2, x1:x2] = resized[:qh, :qw]
        b = boxes * s + np.array([x1, y1, x1, y1], np.float32)
        b[:, [0, 2]] = b[:, [0, 2]].clip(x1, x2)
        b[:, [1, 3]] = b[:, [1, 3]].clip(y1, y2)
        keep = ((b[:, 2] - b[:, 0]) > 2) & ((b[:, 3] - b[:, 1]) > 2)
        all_boxes.append(b[keep])
        all_cls.append(cls[keep])
    boxes = (
        np.concatenate(all_boxes).astype(np.float32)
        if all_boxes
        else np.zeros((0, 4), np.float32)
    )
    classes = (
        np.concatenate(all_cls).astype(np.int32)
        if all_cls
        else np.zeros(0, np.int32)
    )
    return canvas, boxes, classes


def copy_paste(
    img: np.ndarray,
    boxes: np.ndarray,
    classes: np.ndarray,
    donor_img: np.ndarray,
    donor_boxes: np.ndarray,
    donor_classes: np.ndarray,
    rng: np.random.Generator,
    p: float = 0.05,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Copy-paste augmentation: paste each donor object region into the
    target image with probability ``p`` (the reference trains with
    copy_paste=0.05 — train-yolo-custom-tt100k.ipynb cell 36).  Box-region
    paste (signs are rectangular; no mask data exists in YOLO labels)."""
    img = img.copy()
    out_boxes = [boxes]
    out_classes = [classes]
    h, w = img.shape[:2]
    for b, c in zip(donor_boxes, donor_classes):
        if rng.uniform() >= p:
            continue
        x1, y1, x2, y2 = (int(v) for v in b)
        bw, bh = x2 - x1, y2 - y1
        if bw < 4 or bh < 4 or bw >= w or bh >= h:
            continue
        nx = int(rng.uniform(0, w - bw))
        ny = int(rng.uniform(0, h - bh))
        img[ny : ny + bh, nx : nx + bw] = donor_img[y1:y2, x1:x2]
        out_boxes.append(
            np.asarray([[nx, ny, nx + bw, ny + bh]], np.float32)
        )
        out_classes.append(np.asarray([c], np.int32))
    return (
        img,
        np.concatenate(out_boxes).astype(np.float32),
        np.concatenate(out_classes).astype(np.int32),
    )


# --------------------------------------------------------------------- #
# classifier-side soft-label augments                                    #
# --------------------------------------------------------------------- #


def mixup_batch(
    images: np.ndarray,
    onehot: np.ndarray,
    rng: np.random.Generator,
    alpha: float = 0.4,
) -> Tuple[np.ndarray, np.ndarray]:
    """MixUp over a batch (reference collate: alpha 0.4)."""
    lam = rng.beta(alpha, alpha)
    perm = rng.permutation(len(images))
    images = lam * images + (1 - lam) * images[perm]
    onehot = lam * onehot + (1 - lam) * onehot[perm]
    return images.astype(np.float32), onehot.astype(np.float32)


def cutmix_batch(
    images: np.ndarray,
    onehot: np.ndarray,
    rng: np.random.Generator,
    alpha: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """CutMix over a batch (reference collate: alpha 1.0)."""
    lam = rng.beta(alpha, alpha)
    perm = rng.permutation(len(images))
    h, w = images.shape[1:3]
    cut = np.sqrt(1 - lam)
    cw, ch = int(w * cut), int(h * cut)
    cx, cy = int(rng.uniform(0, w)), int(rng.uniform(0, h))
    x1, x2 = np.clip([cx - cw // 2, cx + cw // 2], 0, w)
    y1, y2 = np.clip([cy - ch // 2, cy + ch // 2], 0, h)
    out = images.copy()
    out[:, y1:y2, x1:x2] = images[perm][:, y1:y2, x1:x2]
    lam_adj = 1 - (x2 - x1) * (y2 - y1) / (w * h)
    onehot = lam_adj * onehot + (1 - lam_adj) * onehot[perm]
    return out.astype(np.float32), onehot.astype(np.float32)


def mix_collate(
    images: np.ndarray,
    labels: np.ndarray,
    num_classes: int,
    rng: np.random.Generator,
    p: float = 0.7,
    mixup_alpha: float = 0.4,
    cutmix_alpha: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's collate: with probability p apply MixUp or CutMix
    (coin flip between them), else plain one-hot labels
    (train-model-tsr-tt100k.ipynb cells 12-13)."""
    onehot = np.eye(num_classes, dtype=np.float32)[labels]
    if rng.uniform() >= p:
        return images.astype(np.float32), onehot
    if rng.uniform() < 0.5:
        return mixup_batch(images, onehot, rng, mixup_alpha)
    return cutmix_batch(images, onehot, rng, cutmix_alpha)
