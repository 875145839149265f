"""The port's metric oracles (``litepi_tpu_torch/evals``) against the JAX
package's (``litepi_tpu/evals``) on the same seeded prediction sets: every
output equal to the last digit (NaN where NaN), in each metrics mode.

The sets hold images with no predictions, images with no ground truth,
empty images, classes that never occur in the ground truth (and classes
only predicted), wrong-class matches, duplicate and jittered boxes, ties of
score.  The label parser is held on edge rows (blank, short, extra columns,
float class ids, boxes past the image, a missing file).
"""

import math

import numpy as np
import pytest

import litepi_tpu.evals as jax_evals
import litepi_tpu_torch.evals as port_evals
from litepi_tpu.evals import level0 as jax_level0
from litepi_tpu.evals import map as jax_map
from litepi_tpu.evals import reference as jax_reference
from litepi_tpu_torch.evals import level0 as port_level0
from litepi_tpu_torch.evals import map as port_map
from litepi_tpu_torch.evals import reference as port_reference


def assert_same(got, want, where="result"):
    """Recursive equality: the same types of container, arrays equal
    element for element with NaN equal to NaN, floats bit-equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, float):
        assert type(got) is type(want), where
        assert (math.isnan(got) and math.isnan(want)) or got == want, f"{where}: {got} != {want}"
    else:
        assert type(got) is type(want) and got == want, f"{where}: {got!r} != {want!r}"


def prediction_set(seed, n_images=12, num_classes=7):
    """(preds, gts): per image (boxes, scores, labels) and (boxes,
    classes), float32 boxes with integer-truncated copies mixed in."""
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for i in range(n_images):
        kind = i % 6
        n_gt = 0 if kind in (0, 1) else int(rng.integers(1, 6))
        xy = rng.uniform(0, 500, (n_gt, 2))
        wh = rng.uniform(8, 120, (n_gt, 2))
        gt = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        # classes 0..3 only: 4..6 never occur in the ground truth
        gt_cls = rng.integers(0, 4, n_gt).astype(np.int32)
        if kind == 0:  # empty image: nothing predicted, nothing labelled
            p = np.zeros((0, 4), np.float32)
            s = np.zeros(0, np.float32)
            c = np.zeros(0, np.int32)
        else:
            hit = gt + rng.normal(0, rng.choice([1.0, 6.0, 20.0]), gt.shape).astype(np.float32)
            xy = rng.uniform(0, 500, (int(rng.integers(0, 4)), 2))
            fp = np.concatenate([xy, xy + rng.uniform(5, 60, xy.shape)], 1).astype(np.float32)
            p = np.concatenate([hit, hit[:1], fp]).astype(np.float32)  # a duplicate
            s = rng.choice([0.9, 0.5, 0.25, 0.05], len(p)).astype(np.float32)  # ties
            s += rng.uniform(0, 0.04, len(p)).astype(np.float32) * (rng.uniform(size=len(p)) < 0.7)
            c = np.concatenate([gt_cls, gt_cls[:1],
                                rng.integers(0, num_classes, len(fp))]).astype(np.int32)
            flip = rng.uniform(size=len(c)) < 0.15  # wrong-class predictions
            c[flip] = (c[flip] + 1) % num_classes
            if kind == 3:
                p = np.trunc(p)
        preds.append((p, s, c))
        gts.append((gt, gt_cls))
    return preds, gts


SEEDS = [0, 1, 2]


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_evaluator_equal(seed):
    preds, gts = prediction_set(seed)
    assert_same(port_reference.evaluate_predictions_reference(preds, gts, 7),
                jax_reference.evaluate_predictions_reference(preds, gts, 7))


@pytest.mark.parametrize("seed", SEEDS)
def test_ultralytics_evaluator_equal(seed):
    preds, gts = prediction_set(seed)
    assert_same(port_map.evaluate_predictions(preds, gts, 7),
                jax_map.evaluate_predictions(preds, gts, 7))


@pytest.mark.parametrize("seed", SEEDS)
def test_level0_evaluator_equal(seed):
    """Including the classes without ground truth (zero division -> 0) and
    the per-class arrays the evaluator turns into NaN mAP columns."""
    preds, gts = prediction_set(seed)
    got = port_level0.evaluate_predictions_level0(preds, gts, 7)
    assert_same(got, jax_level0.evaluate_predictions_level0(preds, gts, 7))
    assert (got["tp"][4:] == 0).all()


def test_matchers_and_ap_equal():
    preds, gts = prediction_set(5)
    for (p, _, c), (g, gc) in zip(preds, gts):
        assert_same(port_map.match_predictions(p, c, g, gc),
                    jax_map.match_predictions(p, c, g, gc))
        assert_same(port_reference.match_predictions_reference(p, c, g, gc),
                    jax_reference.match_predictions_reference(p, c, g, gc))
    rng = np.random.default_rng(6)
    for n in (0, 1, 7):
        r = np.sort(rng.uniform(0, 1, n))
        q = rng.uniform(0, 1, n)
        assert_same(port_reference.compute_ap_reference(r, q),
                    jax_reference.compute_ap_reference(r, q))


def test_all_empty_and_no_gt_sets():
    """No image holds ground truth; then no image holds anything."""
    preds, _ = prediction_set(3, n_images=4)
    no_gt = [(np.zeros((0, 4), np.float32), np.zeros(0, np.int32))] * 4
    empty = [(np.zeros((0, 4), np.float32), np.zeros(0, np.float32), np.zeros(0, np.int32))] * 4
    for p in (preds, empty):
        assert_same(port_reference.evaluate_predictions_reference(p, no_gt, 7),
                    jax_reference.evaluate_predictions_reference(p, no_gt, 7))
        assert_same(port_map.evaluate_predictions(p, no_gt, 7),
                    jax_map.evaluate_predictions(p, no_gt, 7))
        assert_same(port_level0.evaluate_predictions_level0(p, no_gt, 7),
                    jax_level0.evaluate_predictions_level0(p, no_gt, 7))


def test_parse_yolo_label_edge_rows(tmp_path):
    text = ("\n"
            "0 0.5 0.5 0.2 0.4\n"
            "1 0.1 0.2\n"                       # short row: skipped
            "   \n"
            "2.0 0.95 0.05 0.3 0.3 0.77 extra\n"  # float class, extra columns, past the edge
            "3 0 0 0 0\n"                       # zero-size box
            "4 1e-3 0.999 2.5 1.5\n")
    path = tmp_path / "img.txt"
    path.write_text(text)
    for w, h in ((640, 480), (1, 1), (2048, 2048)):
        got = port_evals.parse_yolo_label(str(path), w, h)
        assert_same(got, jax_evals.parse_yolo_label(str(path), w, h))
        assert got[1].tolist() == [0, 2, 3, 4]
    missing = str(tmp_path / "missing.txt")
    assert_same(port_evals.parse_yolo_label(missing, 10, 10),
                jax_evals.parse_yolo_label(missing, 10, 10))


def test_class_names_and_sampling_equal(tmp_path):
    (tmp_path / "idx2label.json").write_text('{"0": "stop", "12": "yield"}')
    (tmp_path / "names.txt").write_text("stop\n\nyield\n")
    for name in ("idx2label.json", "names.txt"):
        p = str(tmp_path / name)
        assert port_evals.load_class_names(p) == jax_evals.load_class_names(p)
    for i in range(9):
        (tmp_path / f"img{i}.{('jpg', 'PNG', 'txt')[i % 3]}").write_bytes(b"")
    for n in (None, 3, 100):
        assert (port_evals.sample_images(str(tmp_path), n, seed=7)
                == jax_evals.sample_images(str(tmp_path), n, seed=7))
