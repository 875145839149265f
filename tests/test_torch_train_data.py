"""The port's training data pipeline against the JAX package's
(``litepi_tpu_torch/data/{augment,dataset}.py``, ``core/types.py::
ablation_configs``): with the same seed every augmentation, every batch
and every epoch's stream is equal bit for bit (tolerance: none)."""

import dataclasses

import numpy as np
import pytest

import litepi_tpu.data.augment as ja
import litepi_tpu.data.dataset as jd
import litepi_tpu_torch.data.augment as pa
import litepi_tpu_torch.data.dataset as pd
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _equal(a, b):
    """Nested tuples / dicts of arrays equal leaf for leaf, dtypes too."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _samples(seed, n=4):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = rng.integers(60, 140, 2)
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        xy = rng.uniform(0, [w - 20, h - 20], (3, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(6, 20, (3, 2))], -1).astype(np.float32)
        out.append((img, boxes, np.arange(3, dtype=np.int32) + i))
    return out


# each case: (name, call(module, rng)) with the same draws on both sides
CASES = {
    "hsv": lambda m, rng: m.hsv_augment(_samples(1)[0][0], rng),
    "flip": lambda m, rng: m.random_flip_lr(*_samples(2)[0][:2], rng, p=0.5),
    "scale_shift": lambda m, rng: m.random_scale_shift(*_samples(3)[0][:2], rng, 0.5, 160),
    "mosaic4": lambda m, rng: m.mosaic4(_samples(4), rng, 160),
    "copy_paste": lambda m, rng: m.copy_paste(*_samples(5)[0], *_samples(6)[1], rng, p=0.7),
    "mixup": lambda m, rng: m.mixup_batch(
        np.random.default_rng(7).uniform(0, 1, (6, 16, 16, 3)).astype(np.float32),
        np.eye(5, dtype=np.float32)[[0, 1, 2, 3, 4, 0]], rng),
    "cutmix": lambda m, rng: m.cutmix_batch(
        np.random.default_rng(8).uniform(0, 1, (6, 16, 16, 3)).astype(np.float32),
        np.eye(5, dtype=np.float32)[[0, 1, 2, 3, 4, 0]], rng),
    "mix_collate": lambda m, rng: [m.mix_collate(
        np.random.default_rng(9).uniform(0, 1, (6, 16, 16, 3)).astype(np.float32),
        np.array([0, 1, 2, 3, 4, 0]), 5, rng) for _ in range(6)],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_augment_equals_jax(case):
    for seed in range(3):
        want = CASES[case](ja, np.random.default_rng(seed))
        got = CASES[case](pa, np.random.default_rng(seed))
        _equal(got, want)


@pytest.fixture(scope="module")
def det_tree(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("det")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):
        h, w = int(rng.integers(90, 150)), int(rng.integers(100, 180))
        img = rng.integers(0, 120, (h, w, 3), dtype=np.uint8)
        cv2.rectangle(img, (w // 3, h // 3), (w // 2, h // 2), (250, 250, 250), -1)
        cv2.imwrite(str(root / "images" / f"im{i}.jpg"), img)
        if i != 4:  # one negative image, no label file
            (root / "labels" / f"im{i}.txt").write_text(
                f"{i % 2} 0.42 0.42 0.17 0.17\n1 0.7 0.6 0.1 0.2\n")
    return root


@pytest.fixture(scope="module")
def crop_tree(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("crops")
    rng = np.random.default_rng(1)
    for c in ("a", "b", "c"):
        (root / c).mkdir()
        for i in range(3):
            img = rng.integers(0, 255, (int(rng.integers(20, 50)), 30, 3), dtype=np.uint8)
            cv2.imwrite(str(root / c / f"{i}.png"), img)
    return root


@pytest.mark.parametrize("augment", [True, False])
def test_detection_batches_equal_jax(det_tree, augment):
    """Two epochs' batches (``seed_epoch`` the resume cursor), mosaic,
    scale-shift, copy-paste, HSV and flip on, or the plain letterbox."""
    kw = dict(input_size=96, max_gt=6, augment=augment, copy_paste_p=0.5, seed=3)
    args = (str(det_tree / "images"), str(det_tree / "labels"))
    j, p = jd.DetectionDataset(*args, **kw), pd.DetectionDataset(*args, **kw)
    assert p.pairs == j.pairs == jd.list_pairs(*args) == pd.list_pairs(*args)
    for epoch in (1, 0):
        j.seed_epoch(epoch)
        p.seed_epoch(epoch)
        _equal(list(p.batches(3, steps=2)), list(j.batches(3, steps=2)))


@pytest.mark.parametrize("augment", [True, False])
def test_crop_batches_equal_jax(crop_tree, augment):
    kw = dict(input_size=24, mean=(0.2, 0.3, 0.4), std=(0.3, 0.3, 0.2), augment=augment,
              mix_p=0.7, seed=5)
    j, p = jd.CropClassificationDataset(str(crop_tree), **kw), pd.CropClassificationDataset(
        str(crop_tree), **kw)
    assert p.classes == j.classes and p.samples == j.samples
    for epoch in (2, 0):
        j.seed_epoch(epoch)
        p.seed_epoch(epoch)
        _equal(list(p.batches(4, steps=3)), list(j.batches(4, steps=3)))
    # a batch larger than the set wraps around, as the JAX dataset's
    _equal(list(p.batches(16, steps=1, shuffle=False)), list(j.batches(16, steps=1, shuffle=False)))


def test_prefetcher_keeps_order():
    items = [{"i": np.full(3, k)} for k in range(7)]
    _equal(list(pd.Prefetcher(iter(items), depth=2)), items)


def test_prefetcher_raises_the_worker_error():
    """A batch that fails to load fails the epoch, after the batches that
    came before it, instead of ending it short."""

    def batches():
        yield {"i": np.zeros(3)}
        raise ValueError("corrupt image f001.jpg")

    it = pd.Prefetcher(batches(), depth=2)
    _equal([next(it)], [{"i": np.zeros(3)}])
    with pytest.raises(ValueError, match="corrupt image"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_ablation_configs_equal_jax():
    from litepi_tpu.core.types import ablation_configs as jgrid
    from litepi_tpu_torch.core.types import ablation_configs as pgrid

    for kw in ({}, dict(width_scales=(0.25,), depth_scales=(0.67,), extra=(), num_classes=3)):
        assert [dataclasses.asdict(c) for c in pgrid(**kw)] == [
            dataclasses.asdict(c) for c in jgrid(**kw)]
