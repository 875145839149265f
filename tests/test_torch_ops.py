"""Port ops vs the JAX package: configs, letterbox, anchors, DFL decode and
top-k candidate selection (litepi_tpu_torch/{core,ops})."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litepi_tpu.core import types as jt
from litepi_tpu.ops.anchors import make_anchors as jax_make_anchors
from litepi_tpu.ops.boxes import box_iou as jax_box_iou
from litepi_tpu.ops.dfl import decode_boxes as jax_decode_boxes
from litepi_tpu.ops.dfl import decode_candidates as jax_decode_candidates
from litepi_tpu.ops.dfl import dfl_decode as jax_dfl_decode
from litepi_tpu.ops.letterbox import letterbox_device as jax_letterbox
from litepi_tpu.ops.letterbox import letterbox_params as jax_letterbox_params
from litepi_tpu_torch.core import types as tt
from litepi_tpu_torch.ops.anchors import make_anchors
from litepi_tpu_torch.ops.boxes import box_iou
from litepi_tpu_torch.ops.dfl import (
    decode_boxes,
    decode_candidates,
    dfl_decode,
    topk_stable,
)
from litepi_tpu_torch.ops.letterbox import letterbox_device, letterbox_params


@pytest.mark.parametrize(
    "name",
    ["YOLO_PLUS_V1", "YOLO_PLUS_V2", "YOLOV8N", "DetectorConfig", "NMSConfig",
     "PipelineConfig"],
)
def test_config_copies_equal(name):
    a, b = getattr(jt, name), getattr(tt, name)
    if isinstance(a, type):
        a, b = a(), b()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    if hasattr(a, "channels"):
        for prop in ("channels", "depths", "num_anchors", "reg_channels",
                     "cls_channels", "neck_down_channels"):
            assert getattr(a, prop) == getattr(b, prop), prop


def test_presets_and_helpers_equal():
    assert jt.DATASET_PRESETS == tt.DATASET_PRESETS
    for x in (3.0, 12.0, 16.0, 95.9, 192.0):
        assert jt.make_divisible(x) == tt.make_divisible(x)
    for n, d in ((3, 0.33), (6, 0.33), (1, 0.1), (9, 0.67)):
        assert jt.scale_depth(n, d) == tt.scale_depth(n, d)


@pytest.mark.parametrize("hw", [(300, 200), (200, 300), (160, 160), (100, 160), (480, 640)])
def test_letterbox_matches_jax(hw):
    """Portrait, landscape, identity-size and no-resize frames.  Tolerance
    1e-3 on 0-255 values: both are half-pixel bilinear with clamped taps,
    but XLA sums the hat-matmul and torch lerps, each rounding f32 in its
    own order (a few ulp of 255)."""
    h, w = hw
    assert letterbox_params(h, w, 160) == jax_letterbox_params(h, w, 160)
    rng = np.random.default_rng(h * 7 + w)
    frames = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    want = np.asarray(jax_letterbox(frames, 160, jnp.float32))
    got = letterbox_device(torch.from_numpy(frames), 160, torch.float32).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_anchors_equal():
    for size in (160, 640):
        a, b = make_anchors(size), jax_make_anchors(size)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_box_iou_matches_jax():
    """Valid (x2 >= x1) boxes: bit-equal to the JAX box_iou."""
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 300, (2, 40, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(1, 80, (2, 40, 2))], -1).astype(np.float32)
    want = np.asarray(jax_box_iou(boxes, boxes))
    got = box_iou(torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy()
    np.testing.assert_array_equal(got, want)


def test_dfl_decode_matches_jax():
    """Softmax expectation in f32: 1e-5 px for the reduction order."""
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 2, (2, 50, 64)).astype(np.float32)
    want = np.asarray(jax_dfl_decode(logits, 16))
    got = dfl_decode(torch.from_numpy(logits), 16).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("xywh", [False, True])
def test_decode_boxes_matches_jax(xywh):
    rng = np.random.default_rng(5)
    dist = rng.uniform(0, 15, (2, 525, 4)).astype(np.float32)
    pts, strides = jax_make_anchors(160)
    want = np.asarray(jax_decode_boxes(dist, pts, strides, xywh))
    got = decode_boxes(
        torch.from_numpy(dist), torch.from_numpy(pts), torch.from_numpy(strides), xywh
    ).numpy()
    np.testing.assert_array_equal(got, want)


def _tied_head(seed, b=2, a=336, nc=3):
    """A head output whose class logits come from a coarse grid of values,
    so that many anchors and classes tie exactly."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(-8, 3, (b, a, nc)).astype(np.float32) * 0.5
    reg = rng.normal(0, 1, (b, a, 64)).astype(np.float32)
    return {"reg": reg, "cls": cls}


@pytest.mark.parametrize("seed", [0, 1])
def test_topk_ties_match_lax_top_k(seed):
    head = _tied_head(seed)
    scores = np.asarray(jax.nn.sigmoid(head["cls"])).max(-1)
    assert len(np.unique(scores)) < scores.shape[-1] // 10  # many ties
    for k in (16, 64, 336):
        _, want = jax.lax.top_k(scores, k)
        _, got = topk_stable(torch.from_numpy(scores), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_candidates_matches_jax(seed):
    """Same candidates (class ids exact, ties to the lower index), scores
    to 1e-6 (sigmoid), boxes to 1e-3 px (softmax reduction order x stride)."""
    head = _tied_head(seed)
    pts, strides = jax_make_anchors(160)
    want = jax_decode_candidates(
        {k: jnp.asarray(v) for k, v in head.items()},
        jnp.asarray(pts), jnp.asarray(strides), 16, 64, "exact",
    )
    got = decode_candidates(
        {k: torch.from_numpy(v) for k, v in head.items()},
        torch.from_numpy(pts), torch.from_numpy(strides), 16, 64, "exact",
    )
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-3, rtol=0)
    # "approx" is the TPU's approx_max_k: the port runs the exact selection
    apx = decode_candidates(
        {k: torch.from_numpy(v) for k, v in head.items()},
        torch.from_numpy(pts), torch.from_numpy(strides), 16, 64, "approx",
    )
    for x, y in zip(apx, got):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    with pytest.raises(ValueError, match="unknown candidate selector"):
        decode_candidates(
            {k: torch.from_numpy(v) for k, v in head.items()},
            torch.from_numpy(pts), torch.from_numpy(strides), 16, 64, "typo",
        )
