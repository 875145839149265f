"""The ROI kernel's plain versions (litepi_tpu_torch/ops/roi.py) vs the JAX
package: dense mode against ops/roi.py::crop_and_resize in float32, pyramid
mode against ops/pallas_roi.py::pallas_crop_and_resize in interpret mode.

Tolerance 1e-3 on 0-255 pixel values: the taps and hat weights are the
same numbers, but XLA sums the hat-weighted matmul (possibly with fused
multiply-adds) where the port rounds each product and sum once; the
difference is a few ulp of 255 (~3e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litepi_tpu.ops.pallas_roi import EXACT_EXTENT as JAX_EXACT_EXTENT
from litepi_tpu.ops.pallas_roi import pallas_crop_and_resize
from litepi_tpu.ops.roi import crop_and_resize as jax_crop
from litepi_tpu_torch.ops.roi import (
    EXACT_EXTENT,
    build_pyramid,
    crop_and_resize,
    crop_and_resize_pyramid,
    pyramid_scales,
)

ATOL = 1e-3


def _dense_pair(img, boxes, valid, out=64):
    want = np.asarray(jax_crop(img, boxes, valid, out, jnp.float32))
    got = crop_and_resize(
        torch.from_numpy(img), torch.from_numpy(boxes), torch.from_numpy(valid), out
    ).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    return got


def _pyramid_pair(img, boxes, valid, out=64):
    want = np.asarray(
        pallas_crop_and_resize(img, boxes, valid, out, True, jnp.float32)
    )
    got = crop_and_resize_pyramid(
        torch.from_numpy(img), torch.from_numpy(boxes), torch.from_numpy(valid), out
    ).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    return got


# degenerate, zero-area, border-straddling, out-of-frame, exactly
# EXACT_EXTENT and larger-than-EXACT_EXTENT boxes
EDGE_BOXES = [
    [3.4, 5.1, 3.4 + 118.0, 5.1 + 80.0],
    [0.0, 0.0, 1.0, 1.0],
    [50.0, 50.0, 50.0, 50.0],      # zero area -> 1x1 after truncation
    [20.7, 30.2, 20.9, 90.0],      # zero width after floor
    [380.0, 10.0, 400.0, 60.0],    # right edge
    [-10.0, -5.0, 30.0, 25.0],     # outside top-left
    [10.0, 12.0, 390.0, 290.0],    # > EXACT_EXTENT: pyramid level 1
    [0.0, 0.0, 400.0, 300.0],      # whole frame
]


def test_exact_extent_matches_jax():
    assert EXACT_EXTENT == JAX_EXACT_EXTENT


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_matches_jax(seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (2, 300, 400, 3), dtype=np.uint8)
    boxes = np.array([EDGE_BOXES, EDGE_BOXES[::-1]], np.float32)
    valid = np.ones(boxes.shape[:2], bool)
    valid[1, 2] = False
    got = _dense_pair(img, boxes, valid)
    assert (got[1, 2] == 0).all() and got[0].sum() > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_pyramid_matches_pallas(seed):
    rng = np.random.default_rng(10 + seed)
    img = rng.integers(0, 256, (2, 300, 400, 3), dtype=np.uint8)
    boxes = np.array([EDGE_BOXES, EDGE_BOXES[::-1]], np.float32)
    valid = np.ones(boxes.shape[:2], bool)
    valid[0, 3] = False
    got = _pyramid_pair(img, boxes, valid)
    assert (got[0, 3] == 0).all()


def test_pyramid_three_levels_matches_pallas():
    """A frame long enough for two pooled levels (640 // 16 = 40)."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (1, 200, 640, 3), dtype=np.uint8)
    assert pyramid_scales(200, 640) == [1, 4, 16]
    boxes = np.array(
        [[[0.0, 0.0, 640.0, 200.0], [100.0, 20.0, 580.0, 190.0],
          [5.0, 5.0, 60.0, 60.0], [600.0, 150.0, 640.0, 200.0]]],
        np.float32,
    )
    _pyramid_pair(img, boxes, np.ones((1, 4), bool), out=32)


def test_pyramid_levels_round_half_to_even():
    """Level k is the 4x4 mean of level k-1, rounded half to even
    (jnp.round's rule) into uint8."""
    img = np.zeros((1, 8, 8, 1), np.uint8)
    img[0, :4, :4, 0] = 1          # mean 1.0
    img[0, :4, 4:, 0] = [[0, 0, 0, 0]] * 3 + [[0, 0, 0, 8]]   # mean 0.5 -> 0
    img[0, 4:, :4, 0] = [[2] * 4] * 3 + [[2, 2, 2, 10]]     # mean 2.5 -> 2
    img[0, 4:, 4:, 0] = [[3] * 4] * 3 + [[3, 3, 3, 11]]     # mean 3.5 -> 4
    lvl = build_pyramid(torch.from_numpy(img), 2)[1]
    np.testing.assert_array_equal(lvl[0, :, :, 0].numpy(), [[1, 0], [2, 4]])


def test_small_boxes_pyramid_equals_dense():
    """Below EXACT_EXTENT both modes sample the frame itself."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (1, 300, 400, 3), dtype=np.uint8)
    boxes = np.array([[[3.0, 4.0, 121.0, 90.0], [200.5, 100.2, 260.9, 180.0]]],
                     np.float32)
    t = [torch.from_numpy(x) for x in (img, boxes, np.ones((1, 2), bool))]
    np.testing.assert_array_equal(
        crop_and_resize(*t).numpy(), crop_and_resize_pyramid(*t).numpy()
    )


def test_zero_roi_budget():
    img = torch.zeros((2, 64, 64, 3), dtype=torch.uint8)
    boxes = torch.zeros((2, 0, 4))
    valid = torch.zeros((2, 0), dtype=torch.bool)
    for fn in (crop_and_resize, crop_and_resize_pyramid):
        assert fn(img, boxes, valid, 64).shape == (2, 0, 64, 64, 3)


def test_frames_must_be_uint8():
    with pytest.raises(ValueError, match="uint8"):
        crop_and_resize(
            torch.zeros((1, 32, 32, 3)), torch.zeros((1, 1, 4)),
            torch.ones((1, 1), dtype=torch.bool),
        )
