"""The NMS kernel's plain version (litepi_tpu_torch/ops/nms.py) vs the JAX
package: keep masks bit-equal to the Pallas kernel in interpret mode, to
the JAX fixpoint and to the per-class numpy oracle; nms_sorted outputs
equal to the JAX nms_sorted."""

import numpy as np
import pytest
import torch

from litepi_tpu.ops.nms import nms_numpy_reference as jax_oracle
from litepi_tpu.ops.nms import nms_sorted as jax_nms_sorted
from litepi_tpu.ops.nms import suppress_sorted as jax_suppress_sorted
from litepi_tpu.ops.pallas_nms import pallas_suppress
from litepi_tpu_torch.ops.nms import (
    nms_numpy_reference,
    nms_sorted,
    suppress,
    suppress_sorted,
)


def _sorted_dets(rng, b, k, n_real, num_classes):
    """b images of k score-descending candidates, the first n_real valid,
    boxes crowded so that suppression chains form."""
    x1 = rng.uniform(0, 150, (b, k))
    y1 = rng.uniform(0, 150, (b, k))
    w = rng.uniform(8, 200, (b, k))
    h = rng.uniform(8, 200, (b, k))
    boxes = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    scores = -np.sort(-rng.uniform(0.3, 1.0, (b, k)).astype(np.float32), -1)
    scores[:, n_real:] = 0.0
    # skewed class ids: even with 91 classes, same-class pairs are common
    cls = np.minimum(rng.geometric(0.3, (b, k)) - 1, num_classes - 1).astype(np.int32)
    valid = np.arange(k)[None, :] < n_real
    return boxes, scores, cls, np.broadcast_to(valid, (b, k)).copy()


def _oracle_keep(boxes, scores, cls, valid, thr):
    keep = np.zeros(len(boxes), bool)
    idx = np.nonzero(valid)[0]
    for c in np.unique(cls[idx]):
        sel = idx[cls[idx] == c]
        kept = nms_numpy_reference(boxes[sel], scores[sel], thr)
        # the port's oracle copy agrees with the JAX package's
        np.testing.assert_array_equal(kept, jax_oracle(boxes[sel], scores[sel], thr))
        keep[sel[kept]] = True
    return keep


@pytest.mark.parametrize("num_classes", [1, 3, 91])
@pytest.mark.parametrize("k", [64, 128, 512])
def test_keep_mask_bit_equal(k, num_classes):
    rng = np.random.default_rng(k + num_classes)
    b = 2
    boxes, scores, cls, valid = _sorted_dets(rng, b, k, k - 7, num_classes)
    thr = 0.45
    got = suppress_sorted(
        torch.from_numpy(boxes), torch.from_numpy(valid), torch.from_numpy(cls), thr
    ).numpy()
    pallas = np.asarray(
        pallas_suppress(
            np.swapaxes(boxes, -1, -2),
            cls.astype(np.float32)[:, None, :],
            valid,
            thr,
            True,  # interpret mode
        )
    )
    fixpoint = np.asarray(jax_suppress_sorted(boxes, valid, cls, thr))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, fixpoint)
    for i in range(b):
        np.testing.assert_array_equal(
            got[i], _oracle_keep(boxes[i], scores[i], cls[i], valid[i], thr)
        )
    # the fixture must suppress something and keep something
    assert 0 < got.sum() < valid.sum()


def test_all_invalid_keeps_nothing():
    boxes = np.zeros((2, 64, 4), np.float32)
    cls = np.zeros((2, 64), np.int32)
    valid = np.zeros((2, 64), bool)
    keep = suppress(torch.from_numpy(boxes), torch.from_numpy(valid),
                    torch.from_numpy(cls), 0.45)
    assert keep.dtype == torch.bool and not keep.any()


def _nms_pair(boxes, scores, cls, conf, thr, max_det):
    want = jax_nms_sorted(boxes, scores, cls, conf, thr, max_det, use_pallas=False)
    got = nms_sorted(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(cls),
        conf, thr, max_det,
    )
    for name, g, w in zip(("boxes", "scores", "class_ids", "valid"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    return got


@pytest.mark.parametrize("num_classes", [1, 3])
def test_nms_sorted_matches_jax(num_classes):
    rng = np.random.default_rng(20 + num_classes)
    boxes, scores, cls, _ = _sorted_dets(rng, 3, 64, 50, num_classes)
    out = _nms_pair(boxes, scores, cls, 0.35, 0.45, 48)
    assert out[3].any() and not out[3].all()
    assert out[2].dtype == torch.int32


def test_nms_sorted_pads_when_k_below_max_detections():
    rng = np.random.default_rng(5)
    boxes, scores, cls, _ = _sorted_dets(rng, 2, 5, 4, 2)
    out = _nms_pair(boxes, scores, cls, 0.25, 0.45, 8)
    assert out[0].shape == (2, 8, 4)
    assert (out[2].numpy()[:, 5:] == -1).all()


def test_nms_sorted_everything_below_conf():
    rng = np.random.default_rng(6)
    boxes, scores, cls, _ = _sorted_dets(rng, 2, 32, 32, 1)
    out = _nms_pair(boxes, scores, cls, 1.5, 0.45, 8)
    assert not out[3].any() and (out[2].numpy() == -1).all()
