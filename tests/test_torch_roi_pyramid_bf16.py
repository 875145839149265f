"""The pyramid crop in the pipeline's dtype: the port's plain pyramid crop
(litepi_tpu_torch/ops/roi.py::crop_and_resize_pyramid) against the JAX
Pallas kernel ops/pallas_roi.py::pallas_crop_and_resize in interpret mode,
in bfloat16 and float32, on the same uint8 frames and boxes; then the bf16
``run_fused`` with ``roi_impl="pallas"`` against the JAX bf16 program.

Tolerances.  bf16: exact.  The Pallas kernel rounds its hat weights to
bf16 and its y-pass dot to bf16 before the x-pass; the port rounds the same
values at the same places, every product of a bf16 weight and a uint8 or
bf16 value is exact in float32, and each output sums two non-zero taps, so
each sum rounds once on both sides.  float32: 1e-3 on 0-255 values, as
tests/test_torch_roi.py (XLA may fuse the hat-weighted sums into fused
multiply-adds where the port rounds each product).  The bf16 pipeline is
held inside JAX's own bf16 drift, as tests/test_torch_bf16_parity.py
holds the dense crop's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litepi_tpu.ops.pallas_roi import pallas_crop_and_resize
from litepi_tpu.pipeline import TwoStagePipeline as JaxPipeline
from litepi_tpu_torch.ops.roi import EXACT_EXTENT, crop_and_resize, crop_and_resize_pyramid
from litepi_tpu_torch.pipeline import TwoStagePipeline
from tests.test_torch_bf16_parity import (
    compare,
    conf_in_gap,
    jax_fused_scores,
    numpy_out,
    port_fused_scores,
)
from tests.torch_port_helpers import (
    SMALL,
    jax_init_vars,
    one_torch_thread,  # noqa: F401 (a fixture, used by pytestmark)
    peaked_frames,
    port_config,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# boxes in frame pixels on 300x400 frames: every pyramid level (a 380 px
# box samples level 1), sub-pixel starts, clipped edges, a 1x1 box
BOXES = np.array([
    [[3.4, 5.1, 121.4, 85.1], [10.0, 12.0, 390.0, 290.0], [380.0, 10.0, 400.0, 60.0],
     [-10.0, -5.0, 30.0, 25.0], [0.0, 0.0, 400.0, 300.0], [50.0, 50.0, 50.0, 50.0]],
    [[200.5, 100.2, 260.9, 180.0], [0.7, 0.3, 399.2, 299.9], [120.1, 33.3, 250.6, 280.4],
     [20.7, 30.2, 20.9, 90.0], [5.0, 5.0, 60.0, 60.0], [300.0, 200.0, 398.0, 299.0]],
], np.float32)


def _pair(seed, dtype, out=64):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (2, 300, 400, 3), dtype=np.uint8)
    valid = np.ones(BOXES.shape[:2], bool)
    valid[1, 3] = False
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(pallas_crop_and_resize(img, BOXES, valid, out, True, jdt))
    got = crop_and_resize_pyramid(
        torch.from_numpy(img), torch.from_numpy(BOXES), torch.from_numpy(valid), out,
        compute_dtype=dtype,
    ).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert (got[1, 3] == 0).all()
    return got, want


@pytest.mark.parametrize("seed", [0, 1])
def test_pyramid_bf16_equals_pallas(seed):
    got, want = _pair(seed, torch.bfloat16)
    np.testing.assert_array_equal(got, want)
    # the rounding moves the crop: the float32 crop differs from both
    f32 = _pair(seed, torch.float32)[0]
    assert np.abs(f32 - got).max() > 1e-2


@pytest.mark.parametrize("seed", [0, 1])
def test_pyramid_f32_matches_pallas(seed):
    got, want = _pair(seed, torch.float32)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_pyramid_bf16_small_boxes_equal_dense_bf16():
    """Below EXACT_EXTENT both modes sample the frame itself, and in bf16
    they round at the same places."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (1, 300, 400, 3), dtype=np.uint8)
    boxes = np.array([[[3.0, 4.0, 121.0, 90.0], [200.5, 100.2, 260.9, 180.0]]], np.float32)
    t = [torch.from_numpy(x) for x in (img, boxes, np.ones((1, 2), bool))]
    np.testing.assert_array_equal(
        crop_and_resize(*t, compute_dtype=torch.bfloat16).numpy(),
        crop_and_resize_pyramid(*t, compute_dtype=torch.bfloat16).numpy(),
    )


def test_pyramid_rejects_other_dtypes():
    t = (torch.zeros((1, 32, 32, 3), dtype=torch.uint8), torch.zeros((1, 1, 4)),
         torch.ones((1, 1), dtype=torch.bool))
    with pytest.raises(ValueError, match="compute_dtype"):
        crop_and_resize_pyramid(*t, compute_dtype=torch.float16)


def test_run_fused_bf16_pallas_matches_jax_bf16():
    """The bf16 ``run_fused`` with the pyramid crop against JAX's bf16
    program (its Pallas kernel in interpret mode), inside JAX's own
    bf16-vs-f32 drift, the threshold in a gap of the candidate scores (as
    tests/test_torch_bf16_parity.py holds the dense crop's).  Frames of
    200x300 give the pyramid two levels; a box over EXACT_EXTENT samples
    the second."""
    cfg = dataclasses.replace(SMALL, roi_impl="pallas")
    det, clf = jax_init_vars(SMALL, seed=0)
    jf = JaxPipeline(cfg, det, clf)
    jb = JaxPipeline(cfg, det, clf, dtype=jnp.bfloat16)
    port = TwoStagePipeline.from_jax_vars(port_config(cfg), det, clf, dtype=torch.bfloat16,
                                          device="cpu")
    frames = peaked_frames()
    sb = jax_fused_scores(jb, frames)
    conf, half_gap, drift = conf_in_gap(sb, [jax_fused_scores(jf, frames),
                                             port_fused_scores(port, frames)])
    assert half_gap > drift
    got = numpy_out(port.run_fused(frames, conf))
    b = got["boxes"][got["valid"]]
    assert (np.maximum(b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]) > EXACT_EXTENT + 1).any()
    want = numpy_out(jb.run_fused(frames, conf))
    compare(got, want, numpy_out(jf.run_fused(frames, conf)))
    # the pipeline's crop stage on the run's boxes is the bf16 Pallas crop
    boxes, valid = got["boxes"], got["valid"]
    pallas = pallas_crop_and_resize(frames, boxes, valid, cfg.cls_input_size, True, jnp.bfloat16)
    with torch.inference_mode():
        crops = port._crop(*(torch.from_numpy(x) for x in (frames, boxes, valid)))
    np.testing.assert_array_equal(crops.numpy(),
                                  (torch.from_numpy(np.asarray(pallas)) * (1.0 / 255.0)).numpy())
