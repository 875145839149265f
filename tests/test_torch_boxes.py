"""``ops/boxes.py::unletterbox_boxes`` against the JAX package's, on the
CPU: seeded boxes in letterboxed 640-space mapped back to frame pixels
(within 1e-6), and the letterbox round trip."""

import numpy as np
import pytest
import torch

from litepi_tpu.ops.boxes import unletterbox_boxes as jax_unletterbox_boxes
from litepi_tpu.ops.letterbox import letterbox_params as jax_letterbox_params
from litepi_tpu_torch.ops.boxes import unletterbox_boxes
from litepi_tpu_torch.ops.letterbox import letterbox_params

# (h, w): landscape, portrait, square, TT100K's 2048x2048, and a frame
# smaller than the canvas
FRAMES = ((681, 1198), (1080, 1920), (1198, 681), (640, 640), (2048, 2048), (300, 200))


def _boxes(rng, n, lo, hi):
    """xyxy float32 (n, 4) with corners in [lo, hi): some fall outside the
    frame once mapped back, so the clip has work to do."""
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(0, (hi - lo) / 3, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("hw", FRAMES)
def test_unletterbox_matches_jax(hw):
    h, w = hw
    params = letterbox_params(h, w, 640)
    assert params == jax_letterbox_params(h, w, 640)
    r, dw, dh = params[:3]
    rng = np.random.default_rng(h * 7 + w)
    boxes = _boxes(rng, 64, -40.0, 680.0).reshape(2, 32, 4)
    got = unletterbox_boxes(torch.from_numpy(boxes), r, dw, dh, w, h).numpy()
    want = np.asarray(jax_unletterbox_boxes(boxes, r, dw, dh, w, h))
    assert got.shape == want.shape == (2, 32, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got >= 0).all() and (got[..., 0::2] <= w).all() and (got[..., 1::2] <= h).all()


@pytest.mark.parametrize("hw", FRAMES)
def test_unletterbox_inverts_the_letterbox_mapping(hw):
    """A box in frame pixels, mapped into 640-space by the letterbox
    transform, comes back to itself on both sides."""
    h, w = hw
    r, dw, dh = letterbox_params(h, w, 640)[:3]
    rng = np.random.default_rng(h + 3 * w)
    orig = np.minimum(_boxes(rng, 50, 0.0, 0.7 * min(h, w)), np.float32(min(h, w)))
    in_640 = orig * np.float32(r) + np.array([dw, dh, dw, dh], dtype=np.float32)
    back = unletterbox_boxes(torch.from_numpy(in_640), r, dw, dh, w, h).numpy()
    jax_back = np.asarray(jax_unletterbox_boxes(in_640, r, dw, dh, w, h))
    np.testing.assert_allclose(back, jax_back, rtol=0, atol=1e-6)
    np.testing.assert_allclose(back, orig, rtol=0, atol=1e-3)
