"""The port's host letterbox (``litepi_tpu_torch/ops/letterbox.py::
letterbox_host``) bit-equal to the JAX package's ``letterbox_host`` (canvas,
ratio and padding), on up- and down-scales, portrait and landscape frames,
1x1, the identity size and 2048 -> 640, at the tests' 160 canvas and at 640."""

import numpy as np
import pytest

from litepi_tpu.ops.letterbox import letterbox_host as jax_letterbox_host
from litepi_tpu_torch.ops.letterbox import letterbox_host

# source (h, w)
FRAMES = {
    "down_landscape": (200, 300),
    "down_portrait": (300, 200),
    "up_landscape": (45, 80),
    "up_portrait": (80, 45),
    "one_by_one": (1, 1),
    "odd_portrait": (33, 17),
    "small_landscape": (64, 48),
    "identity_640": (640, 640),
    "tt100k_2048": (2048, 2048),
    "hd_1080x1920": (1080, 1920),
    "near_square": (639, 641),
    "exact_half": (128, 256),
    "wide_strip": (50, 300),
}


@pytest.mark.parametrize("size", [160, 640])
@pytest.mark.parametrize("frame", list(FRAMES))
def test_letterbox_host_bit_equal_to_jax(frame, size):
    hw = FRAMES[frame]
    img = np.random.default_rng(sum(hw)).integers(0, 256, (*hw, 3), dtype=np.uint8)
    got, r, pad = letterbox_host(img, size)
    want, jr, jpad = jax_letterbox_host(img, size)
    assert got.shape == (size, size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (r, pad) == (jr, jpad)


def test_letterbox_host_small_canvas_and_pad_value():
    """A 160 canvas (the tests' detector size) and the 114 border."""
    img = np.zeros((90, 200, 3), np.uint8)
    got, r, (dw, dh) = letterbox_host(img, 160)
    want = jax_letterbox_host(img, 160)[0]
    np.testing.assert_array_equal(got, want)
    assert (got[0] == 114).all() and (got[-1] == 114).all() and dh > 0 and dw == 0
