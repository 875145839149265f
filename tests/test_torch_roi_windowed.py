"""The port's windowed ROI crop (``ops/roi.py::crop_and_resize_windowed``,
``roi_impl="windowed"``) against the JAX package's
``crop_and_resize_windowed`` on the CPU.

Tolerance: 1e-3 on 0-255 values, JAX's own tolerance for its golden tests
of this crop (tests/test_ops_roi.py); 0 measured.  Boxes smaller and larger
than the window (the window's own taps and the 4^k pyramid levels),
float32 and bf16, an invalid slot; for any box of extent <= window - 3 it
equals the dense crop (the JAX docstring's contract, held here exactly);
frames no larger than the window and ``window <= 0`` take the dense crop."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litepi_tpu.ops.roi import crop_and_resize_windowed as jax_windowed
from litepi_tpu_torch.ops.roi import crop_and_resize, crop_and_resize_windowed
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EXTENTS = (10, 40, 100, 125, 200, 290)  # <= window - 3 up to 125, then pyramid levels


def _inputs(seed=0, h=300, w=400):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (2, h, w, 3)).astype(np.uint8)
    boxes = []
    for _ in range(2):
        row = []
        for e in EXTENTS:
            x, y = rng.uniform(0, w - 110), rng.uniform(0, h - 100)
            row.append([x, y, min(x + e, w - 1), min(y + e * 0.8, h - 1)])
        boxes.append(row)
    valid = np.ones((2, len(EXTENTS)), bool)
    valid[1, 2] = False
    return frames, np.asarray(boxes, np.float32), valid


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_matches_jax(dtype):
    frames, boxes, valid = _inputs()
    want = np.asarray(jax_windowed(frames, boxes, valid, 64, getattr(jnp, dtype), 128))
    got = crop_and_resize_windowed(*_t(frames, boxes, valid), 64, getattr(torch, dtype), 128)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-3
    assert not got[1, 2].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_equals_dense_below_the_window(dtype):
    frames, boxes, valid = _inputs(1)
    got = crop_and_resize_windowed(*_t(frames, boxes, valid), 64, getattr(torch, dtype), 128)
    dense = crop_and_resize(*_t(frames, boxes, valid), 64, compute_dtype=getattr(torch, dtype))
    small = [i for i, e in enumerate(EXTENTS) if e <= 125]
    assert torch.equal(got[:, small], dense[:, small])
    assert float((got[:, -1] - dense[:, -1]).abs().max()) > 1.0  # the pyramid's anti-aliasing


def test_small_frames_and_zero_window_take_the_dense_crop():
    frames, boxes, valid = _inputs(2, h=120, w=128)
    boxes = np.clip(boxes, 0, 119)
    dense = crop_and_resize(*_t(frames, boxes, valid), 32)
    assert torch.equal(crop_and_resize_windowed(*_t(frames, boxes, valid), 32,
                                                torch.float32, 128), dense)
    frames, boxes, valid = _inputs(3)
    dense = crop_and_resize(*_t(frames, boxes, valid), 32)
    assert torch.equal(crop_and_resize_windowed(*_t(frames, boxes, valid), 32,
                                                torch.float32, 0), dense)
    want = np.asarray(jax_windowed(frames, boxes, valid, 32, jnp.float32, 0))
    assert float(np.abs(dense.numpy() - want).max()) <= 1e-3
