"""Training datasets (the port's copy of the JAX package's
``litepi_tpu/data/dataset.py``, names and draws unchanged).

* **detection**: YOLO-format image + label directories -> fixed-shape
  batches, boxes padded to ``max_gt`` with a validity mask;
* **classification**: ImageFolder-style crop trees (one subdirectory per
  class).

Batches are numpy on the host; the trainer places them on its device.
``seed_epoch`` makes an epoch's batches a function of (seed, epoch), the
resume cursor.  :class:`Prefetcher` decodes and augments in a background
thread while the device steps.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from litepi_tpu_torch.data.augment import (
    copy_paste,
    hsv_augment,
    mix_collate,
    mosaic4,
    random_flip_lr,
    random_scale_shift,
)
from litepi_tpu_torch.evals.labels import IMAGE_EXTENSIONS, parse_yolo_label


def list_pairs(images_dir: str, labels_dir: str) -> List[Tuple[str, str]]:
    """Sorted (image, label) path pairs; labels may be missing (negatives)."""
    pairs = []
    for f in sorted(os.listdir(images_dir)):
        if f.lower().endswith(IMAGE_EXTENSIONS):
            stem = os.path.splitext(f)[0]
            pairs.append(
                (
                    os.path.join(images_dir, f),
                    os.path.join(labels_dir, stem + ".txt"),
                )
            )
    return pairs


class DetectionDataset:
    """YOLO-format detection dataset with reference-recipe augmentation."""

    def __init__(
        self,
        images_dir: str,
        labels_dir: str,
        input_size: int = 640,
        max_gt: int = 64,
        augment: bool = True,
        mosaic_p: float = 0.7,
        scale: float = 0.5,
        copy_paste_p: float = 0.05,
        seed: int = 0,
    ) -> None:
        self.pairs = list_pairs(images_dir, labels_dir)
        if not self.pairs:
            raise ValueError(f"no images under {images_dir}")
        self.input_size = input_size
        self.max_gt = max_gt
        self.augment = augment
        self.mosaic_p = mosaic_p
        self.scale = scale
        self.copy_paste_p = copy_paste_p
        self._seed = seed
        self.rng = np.random.default_rng(seed)

    def seed_epoch(self, epoch: int) -> None:
        """Reset the augmentation RNG to a pure function of (seed, epoch).

        Makes each epoch's batch stream independent of how many epochs ran
        before it — the dataset cursor for training resume: a run restored at
        epoch k sees exactly the batches the uninterrupted run would have.
        """
        self.rng = np.random.default_rng([self._seed, epoch])

    def __len__(self) -> int:
        return len(self.pairs)

    def _load_raw(self, idx: int):
        import cv2

        img_path, lbl_path = self.pairs[idx]
        img = cv2.imread(img_path)
        if img is None:
            img = np.full((self.input_size, self.input_size, 3), 114, np.uint8)
        boxes, cls = parse_yolo_label(lbl_path, img.shape[1], img.shape[0])
        return img, boxes, cls

    def _load_one(self):
        rng = self.rng
        if self.augment and rng.uniform() < self.mosaic_p:
            idxs = rng.integers(0, len(self.pairs), 4)
            img, boxes, cls = mosaic4(
                [self._load_raw(int(i)) for i in idxs], rng, self.input_size
            )
        else:
            img, boxes, cls = self._load_raw(int(rng.integers(0, len(self.pairs))))
            if self.augment:
                img, boxes = random_scale_shift(
                    img, boxes, rng, self.scale, self.input_size
                )
            else:
                img, boxes = self._letterbox_plain(img, boxes)
        if self.augment:
            if self.copy_paste_p > 0:
                donor = self._load_raw(int(rng.integers(0, len(self.pairs))))
                img, boxes, cls = copy_paste(
                    img, boxes, cls, *donor, rng, self.copy_paste_p
                )
            img = hsv_augment(img, rng)
            img, boxes = random_flip_lr(img, boxes, rng)
        return img, boxes, cls

    def _letterbox_plain(self, img, boxes):
        from litepi_tpu_torch.ops.letterbox import letterbox_host

        canvas, r, (dw, dh) = letterbox_host(img, self.input_size)
        return canvas, boxes * r + np.array([dw, dh, dw, dh], np.float32)

    def batches(
        self, batch_size: int, steps: Optional[int] = None
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite (or ``steps``-bounded) stream of fixed-shape batches:
        images (B,S,S,3) f32 in [0,1]; gt_boxes (B,G,4); gt_labels (B,G);
        gt_mask (B,G)."""
        step = 0
        while steps is None or step < steps:
            imgs = np.zeros(
                (batch_size, self.input_size, self.input_size, 3), np.float32
            )
            gt_boxes = np.zeros((batch_size, self.max_gt, 4), np.float32)
            gt_labels = np.zeros((batch_size, self.max_gt), np.int32)
            gt_mask = np.zeros((batch_size, self.max_gt), bool)
            for b in range(batch_size):
                img, boxes, cls = self._load_one()
                # augs run in cv2-BGR space; the model batch is RGB (the
                # framework's compute convention — reference training is
                # RGB via Ultralytics/torchvision)
                imgs[b] = img[..., ::-1].astype(np.float32) / 255.0
                n = min(len(boxes), self.max_gt)
                gt_boxes[b, :n] = boxes[:n]
                gt_labels[b, :n] = cls[:n]
                gt_mask[b, :n] = True
            yield {
                "images": imgs,
                "gt_boxes": gt_boxes,
                "gt_labels": gt_labels,
                "gt_mask": gt_mask,
            }
            step += 1


class CropClassificationDataset:
    """ImageFolder-style crop dataset (one subdir per class)."""

    def __init__(
        self,
        root: str,
        input_size: int = 64,
        mean: Sequence[float] = (0.18, 0.18, 0.18),
        std: Sequence[float] = (0.34, 0.34, 0.34),
        augment: bool = True,
        mix_p: float = 0.7,
        seed: int = 0,
    ) -> None:
        self.classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        if not self.classes:
            raise ValueError(f"no class subdirectories under {root}")
        self.samples: List[Tuple[str, int]] = []
        for ci, c in enumerate(self.classes):
            cdir = os.path.join(root, c)
            for f in sorted(os.listdir(cdir)):
                if f.lower().endswith(IMAGE_EXTENSIONS):
                    self.samples.append((os.path.join(cdir, f), ci))
        self.input_size = input_size
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.augment = augment
        self.mix_p = mix_p
        self._seed = seed
        self.rng = np.random.default_rng(seed)

    def seed_epoch(self, epoch: int) -> None:
        """Reset shuffle/augment RNG to a pure function of (seed, epoch) —
        the resume cursor (see DetectionDataset.seed_epoch)."""
        self.rng = np.random.default_rng([self._seed, epoch])

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def __len__(self) -> int:
        return len(self.samples)

    def _load(self, idx: int) -> Tuple[np.ndarray, int]:
        import cv2

        path, label = self.samples[idx]
        img = cv2.imread(path)
        if img is None:
            img = np.zeros((self.input_size, self.input_size, 3), np.uint8)
        img = cv2.resize(
            img, (self.input_size, self.input_size),
            interpolation=cv2.INTER_LINEAR,
        )
        if self.augment:
            img = hsv_augment(img, self.rng)  # the ColorJitter analogue
            if self.rng.uniform() < 0.5:
                img = img[:, ::-1].copy()
        return img, label

    def batches(
        self, batch_size: int, steps: Optional[int] = None, shuffle: bool = True
    ) -> Iterator[Dict[str, np.ndarray]]:
        if not len(self.samples):
            raise ValueError("classification dataset is empty")
        order = np.arange(len(self.samples))
        step = 0
        while steps is None or step < steps:
            if shuffle:
                self.rng.shuffle(order)
            # datasets smaller than one batch wrap around (otherwise the
            # epoch yields nothing and the loop spins forever)
            if len(order) < batch_size:
                reps = -(-batch_size // len(order))
                epoch_order = np.tile(order, reps)[:batch_size]
                starts = [0]
            else:
                epoch_order = order
                starts = range(0, len(order) - batch_size + 1, batch_size)
            for start in starts:
                idxs = epoch_order[start : start + batch_size]
                imgs = np.zeros(
                    (batch_size, self.input_size, self.input_size, 3), np.float32
                )
                labels = np.zeros(batch_size, np.int64)
                for i, idx in enumerate(idxs):
                    img, lab = self._load(int(idx))
                    # BGR (cv2 load + augs) -> RGB model batch
                    imgs[i] = img[..., ::-1].astype(np.float32) / 255.0
                    labels[i] = lab
                if self.augment:
                    imgs, soft = mix_collate(
                        imgs, labels, self.num_classes, self.rng, self.mix_p
                    )
                else:
                    soft = np.eye(self.num_classes, dtype=np.float32)[labels]
                imgs = (imgs - self.mean) / self.std
                yield {"images": imgs, "labels": soft, "hard_labels": labels}
                step += 1
                if steps is not None and step >= steps:
                    return


class Prefetcher:
    """Background-thread batch prefetcher: overlaps host decode/augment with
    device steps (the double-buffered host->HBM feed, in its host half).
    An exception the iterator raises (a corrupt image, a bad label) is
    raised again by ``__next__`` in the consumer's thread, so the epoch
    fails instead of ending short."""

    def __init__(self, iterator: Iterator, depth: int = 2) -> None:
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._thread = threading.Thread(
            target=self._fill, args=(iterator,), daemon=True
        )
        self._thread.start()

    def _fill(self, iterator: Iterator) -> None:
        try:
            for item in iterator:
                self._q.put(item)
        except BaseException as e:  # handed to the consumer
            self._q.put(_Failed(e))
        finally:
            self._q.put(self._sentinel)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._sentinel:
            self._q.put(item)  # later calls stop too
            raise StopIteration
        if isinstance(item, _Failed):
            raise item.error
        return item


class _Failed:
    """The exception a :class:`Prefetcher`'s worker thread caught."""

    def __init__(self, error: BaseException) -> None:
        self.error = error
