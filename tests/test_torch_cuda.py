"""The port's CUDA kernels against their plain versions on the card, and the
wrappers' contract off it (litepi_tpu_torch/kernels).

Tests marked ``gpu`` need a CUDA device and skip without one; on a machine
with a card (which need not have JAX) run them with

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

This file imports nothing of JAX or of the JAX package.
"""

import pytest
import torch

from litepi_tpu_torch.core.types import NMSConfig
from litepi_tpu_torch.kernels import LAUNCHES, launch_counts, reset_launch_counts
from litepi_tpu_torch.kernels.act import act_bf16_backward_cuda, act_bf16_cuda
from litepi_tpu_torch.kernels.nms import nms_suppress_cuda
from litepi_tpu_torch.kernels.roi import MAX_OUT, roi_crop_cuda
from litepi_tpu_torch.kernels.stem import MAX_CHANNELS, pack_stem_params, stem_cuda
from litepi_tpu_torch.ops import act
from litepi_tpu_torch.ops.nms import suppress, suppress_sorted
from litepi_tpu_torch.ops.roi import (
    EXACT_EXTENT,
    build_pyramid,
    crop_and_resize,
    crop_and_resize_plain,
    crop_and_resize_pyramid,
    pyramid_scales,
)
from litepi_tpu_torch.ops.stem import fused_stem, stem_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _nms_inputs(gen, b, k, num_classes, dev):
    xy = torch.rand((b, k, 2), generator=gen, device=dev) * 300
    wh = 4 + torch.rand((b, k, 2), generator=gen, device=dev) * 150
    boxes = torch.cat([xy, xy + wh], -1).contiguous()
    cls = torch.randint(0, num_classes, (b, k), generator=gen, device=dev, dtype=torch.int32)
    valid = torch.rand((b, k), generator=gen, device=dev) < 0.8
    return boxes, cls, valid


# ---- off the card: the wrappers' checks and the CPU dispatch -----------


def test_wrappers_reject_cpu_tensors():
    boxes = torch.zeros((1, 8, 4))
    cls = torch.zeros((1, 8), dtype=torch.int32)
    valid = torch.ones((1, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="must be on"):
        nms_suppress_cuda(boxes, cls, valid, 0.45)
    frames = torch.zeros((1, 16, 16, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8 on"):
        roi_crop_cuda([frames], boxes[:, :2], valid[:, :2], 8, EXACT_EXTENT, "dense")
    with pytest.raises(ValueError, match="mode"):
        roi_crop_cuda([frames], boxes[:, :2], valid[:, :2], 8, EXACT_EXTENT, "other")


def test_stem_wrapper_rejects_cpu_tensors_and_wrong_dtypes():
    frames = torch.zeros((1, 80, 80, 3), dtype=torch.uint8)
    weight, bias = torch.zeros((27, 16)), torch.zeros(16)
    with pytest.raises(ValueError, match="CUDA"):
        stem_cuda(frames, weight, bias, torch.bfloat16)
    with pytest.raises(ValueError, match="uint8"):
        stem_cuda(frames.float(), weight, bias, torch.bfloat16)
    with pytest.raises(ValueError, match="bias"):
        stem_cuda(frames, weight, bias.double(), torch.bfloat16)
    with pytest.raises(ValueError, match="out_dtype"):
        stem_cuda(frames, weight, bias, torch.float16)
    with pytest.raises(ValueError, match="even"):
        stem_cuda(frames[:, :79], weight, bias, torch.float32)


def test_wrappers_reject_an_unsupported_size_before_any_launch():
    """An out_size or a channel count the kernels do not take raises before
    the device is even looked at (these tensors are on the CPU)."""
    frames = torch.zeros((1, 16, 16, 3), dtype=torch.uint8)
    boxes, valid = torch.zeros((1, 2, 4)), torch.ones((1, 2), dtype=torch.bool)
    for size in (0, MAX_OUT + 1):
        with pytest.raises(ValueError, match="out_size"):
            roi_crop_cuda([frames], boxes, valid, size, EXACT_EXTENT, "dense")
    for c in (0, MAX_CHANNELS + 1):
        with pytest.raises(ValueError, match="C="):
            stem_cuda(frames, torch.zeros((27, c)), torch.zeros(c), torch.float32)
    before = launch_counts()
    with pytest.raises(ValueError, match="must be \\(27, C\\)"):
        pack_stem_params(torch.zeros((3, 3, 3, 16)), torch.zeros(16))
    with pytest.raises(ValueError, match="bias"):
        pack_stem_params(torch.zeros((27, 16)), torch.zeros(15))
    assert launch_counts() == before


def test_cpu_tensors_take_the_plain_versions():
    reset_launch_counts()
    gen = torch.Generator().manual_seed(0)
    boxes, cls, valid = _nms_inputs(gen, 2, 32, 2, "cpu")
    assert torch.equal(suppress(boxes, valid, cls, 0.45),
                       suppress_sorted(boxes, valid, cls, 0.45))
    frames = torch.randint(0, 256, (2, 40, 50, 3), generator=gen, dtype=torch.uint8)
    out = crop_and_resize(frames, boxes[:, :4] / 8, valid[:, :4], 16)
    assert out.shape == (2, 4, 16, 16, 3)
    assert launch_counts() == {k: 0 for k in LAUNCHES}


# ---- on the card --------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 63, 64, 65, 512, 1024, 1025, 2048])
@pytest.mark.parametrize("num_classes", [1, 3, 91])
@pytest.mark.parametrize("b", [1, 7, 129])
def test_nms_kernel_bit_equal(cuda, k, num_classes, b):
    """K on both sides of the one-kernel bound (64), of a word edge and of
    the shared-memory greedy pass's bound (1,024); B=1 (one block or warp)
    and B=129 (more images than SMs)."""
    gen = torch.Generator(device=cuda).manual_seed(k * 100 + num_classes + 7 * b)
    boxes, cls, valid = _nms_inputs(gen, b, k, num_classes, cuda)
    before = LAUNCHES["nms_suppress"]
    got = nms_suppress_cuda(boxes, cls, valid, 0.45)
    assert LAUNCHES["nms_suppress"] == before + 1
    want = suppress_sorted(boxes, valid, cls, 0.45)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if b <= 7 and k <= 1024:
        # the plain version on the card equals the plain version on the CPU
        # (above 1,024 its CPU fixpoint takes minutes)
        assert torch.equal(
            want.cpu(), suppress_sorted(boxes.cpu(), valid.cpu(), cls.cpu(), 0.45)
        )


@pytest.mark.gpu
def test_nms_kernel_all_invalid_at_k512(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    boxes, cls, _ = _nms_inputs(gen, 4, 512, 1, cuda)
    valid = torch.zeros((4, 512), dtype=torch.bool, device=cuda)
    keep = nms_suppress_cuda(boxes, cls, valid, 0.45)
    torch.cuda.synchronize()
    assert keep.shape == (4, 512) and not keep.any()


@pytest.mark.gpu
def test_nms_kernel_long_chain_at_k1024(cuda):
    """1 class, each box overlapping only the next (IoU 0.6 > 0.45): every
    other box is kept, a chain of 1024 decisions that crosses every word."""
    k = 1024
    x = torch.arange(k, dtype=torch.float32, device=cuda) * 4.0
    boxes = torch.stack([x, torch.zeros_like(x), x + 16.0, torch.full_like(x, 10.0)], -1)
    # shift by 4 of a 16-wide box: IoU(i, i+1) = 12/20, IoU(i, i+2) = 8/24
    boxes = boxes[None].contiguous()
    cls = torch.zeros((1, k), dtype=torch.int32, device=cuda)
    valid = torch.ones((1, k), dtype=torch.bool, device=cuda)
    keep = nms_suppress_cuda(boxes, cls, valid, 0.45)
    want = suppress_sorted(boxes, valid, cls, 0.45)
    torch.cuda.synchronize()
    assert torch.equal(keep, want)
    assert torch.equal(keep[0], torch.arange(k, device=cuda) % 2 == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [64, 512])
def test_nms_kernel_at_the_threshold(cuda, k):
    """Thresholds equal to IoUs that pairs really have and the float32 just
    below each, where the kernel must divide, and thresholds its scaled
    test does not cover (0, negative, subnormal) or that no IoU passes
    (1.0): bit-equal to suppress_sorted at each."""
    gen = torch.Generator(device=cuda).manual_seed(k + 1)
    boxes, cls, valid = _nms_inputs(gen, 4, k, 1, cuda)
    b = boxes[0, :16].cpu()
    wh = (torch.minimum(b[:, None, 2:], b[None, :, 2:])
          - torch.maximum(b[:, None, :2], b[None, :, :2])).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(min=0)
    iou = inter / (area[:, None] + area[None, :] - inter + 1e-6)
    values = iou[torch.ones(16, 16, dtype=torch.bool).triu(1) & (iou > 0)][:4]
    assert values.numel()
    below = torch.nextafter(values, torch.zeros_like(values))
    for thr in [*values.tolist(), *below.tolist(), 0.0, -0.5, 1e-40, 1.0]:
        got = nms_suppress_cuda(boxes, cls, valid, thr)
        want = suppress_sorted(boxes, valid, cls, thr)
        torch.cuda.synchronize()
        assert torch.equal(got, want), thr


@pytest.mark.gpu
@pytest.mark.parametrize("k", [64, 512])
def test_nms_wrapper_counts_one_launch_per_call(cuda, k):
    """Above K=64 the wrapper runs two kernels; it still counts one call."""
    gen = torch.Generator(device=cuda).manual_seed(k)
    boxes, cls, valid = _nms_inputs(gen, 3, k, 1, cuda)
    before = launch_counts()
    nms_suppress_cuda(boxes, cls, valid, 0.45)
    after = launch_counts()
    assert after["nms_suppress"] == before["nms_suppress"] + 1
    assert {n: c for n, c in after.items() if n != "nms_suppress"} == {
        n: c for n, c in before.items() if n != "nms_suppress"}


@pytest.mark.gpu
def test_detect_at_the_default_config_launches_nms_once_without_a_sync(cuda):
    """The staged ``detect`` at the default NMSConfig (K=512 candidates)
    goes through the NMS kernel once per call and never synchronises the
    host; its detections equal nms_sorted over the same candidates with the
    plain keep mask."""
    from litepi_tpu_torch.ops import nms as nms_ops
    from litepi_tpu_torch.pipeline import TwoStagePipeline

    cfg = _small_cfg(nms=NMSConfig())
    assert cfg.nms.max_candidates == 512
    pipe = TwoStagePipeline.initialize(cfg, dtype=torch.bfloat16, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    canvas = torch.rand((2, 160, 160, 3), generator=gen, device=cuda)
    boxes, scores, cls = pipe._detect_top(canvas, cfg.nms.max_candidates)
    assert boxes.shape == (2, 512, 4)
    conf = float(scores[:, 256].min())  # about half of each image's candidates
    pipe.detect(canvas, conf)
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = pipe.detect(canvas, conf)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert launch_counts()["nms_suppress"] == 1
    plain = nms_ops.suppress
    nms_ops.suppress = lambda b, v, c, t: suppress_sorted(b, v, c, t)
    try:
        want = nms_ops.nms_sorted(boxes, scores, cls, conf, cfg.nms.iou_threshold,
                                  cfg.nms.max_detections)
    finally:
        nms_ops.suppress = plain
    for k, w in zip(("boxes", "scores", "class_ids", "valid"), want):
        assert torch.equal(out[k], w), k
    assert out["valid"].any() and out["boxes"].shape == (2, cfg.nms.max_detections, 4)


@pytest.mark.gpu
def test_nms_kernel_edges(cuda):
    boxes = torch.zeros((2, 16, 4), device=cuda)
    cls = torch.zeros((2, 16), dtype=torch.int32, device=cuda)
    none = torch.zeros((2, 16), dtype=torch.bool, device=cuda)
    assert not nms_suppress_cuda(boxes, cls, none, 0.45).any()
    # identical boxes: the first valid one survives
    boxes[..., 2:] = 10.0
    valid = torch.ones((2, 16), dtype=torch.bool, device=cuda)
    keep = nms_suppress_cuda(boxes, cls, valid, 0.45)
    assert keep[:, 0].all() and not keep[:, 1:].any()
    # above 1,024 candidates (the greedy pass in global memory): the same
    # edges, and random candidates bit-equal to the plain version
    big = torch.zeros((2, 1025, 4), device=cuda)
    big_cls = torch.zeros((2, 1025), dtype=torch.int32, device=cuda)
    assert not nms_suppress_cuda(big, big_cls, torch.zeros((2, 1025), dtype=torch.bool,
                                                           device=cuda), 0.45).any()
    big[..., 2:] = 10.0
    big_valid = torch.ones((2, 1025), dtype=torch.bool, device=cuda)
    big_valid[1, :3] = False
    keep = nms_suppress_cuda(big, big_cls, big_valid, 0.45)
    assert keep[0, 0] and keep[1, 3] and int(keep.sum()) == 2
    gen = torch.Generator(device=cuda).manual_seed(1025)
    boxes, cls, valid = _nms_inputs(gen, 2, 1025, 3, cuda)
    assert torch.equal(nms_suppress_cuda(boxes, cls, valid, 0.45),
                       suppress_sorted(boxes, valid, cls, 0.45))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2000, 4096, 8400])
@pytest.mark.parametrize("num_classes", [1, 91])
def test_nms_kernel_bit_equal_at_large_k(cuda, k, num_classes):
    """The RPN's training budget (2,000), a power of two and every anchor
    of the 640 grid (8,400), at B=8 (the plain version's (B, K, K) tensors
    bound the batch): bit-equal, and each case keeps and suppresses."""
    gen = torch.Generator(device=cuda).manual_seed(k + num_classes)
    boxes, cls, valid = _nms_inputs(gen, 8, k, num_classes, cuda)
    got = nms_suppress_cuda(boxes, cls, valid, 0.45)
    want = suppress_sorted(boxes, valid, cls, 0.45)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert 0 < int(got.sum()) < int(valid.sum())


@pytest.mark.gpu
def test_nms_kernel_long_chain_at_k8400(cuda):
    """The chain of test_nms_kernel_long_chain_at_k1024 over 8,400
    candidates: 132 words, each decided on the last one's removed set."""
    k = 8400
    x = torch.arange(k, dtype=torch.float32, device=cuda) * 4.0
    boxes = torch.stack([x, torch.zeros_like(x), x + 16.0, torch.full_like(x, 10.0)], -1)
    boxes = boxes[None].contiguous()
    cls = torch.zeros((1, k), dtype=torch.int32, device=cuda)
    valid = torch.ones((1, k), dtype=torch.bool, device=cuda)
    keep = nms_suppress_cuda(boxes, cls, valid, 0.45)
    torch.cuda.synchronize()
    assert torch.equal(keep[0], torch.arange(k, device=cuda) % 2 == 0)


def _roi_inputs(gen, b, d, h, w, dev):
    frames = torch.randint(0, 256, (b, h, w, 3), generator=gen, device=dev, dtype=torch.uint8)
    x1 = torch.rand((b, d), generator=gen, device=dev) * w - 5
    y1 = torch.rand((b, d), generator=gen, device=dev) * h - 5
    ext = torch.exp(torch.rand((b, d, 2), generator=gen, device=dev) * 6.0) - 1.0
    boxes = torch.stack([x1, y1, x1 + ext[..., 0], y1 + ext[..., 1]], -1).contiguous()
    valid = torch.rand((b, d), generator=gen, device=dev) < 0.85
    return frames, boxes, valid


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(64, 80), (480, 640), (1080, 1920)])
def test_roi_kernel_dense_and_pyramid(cuda, hw):
    """Tolerance 1e-3 on 0-255 values; both round every product and sum once
    in the same order, so 0 is expected."""
    gen = torch.Generator(device=cuda).manual_seed(hw[0])
    frames, boxes, valid = _roi_inputs(gen, 3, 9, *hw, cuda)
    got = crop_and_resize(frames, boxes, valid, 64)
    want = crop_and_resize_plain([frames], boxes, valid, 64)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
    levels = build_pyramid(frames, len(pyramid_scales(*hw)))
    got = crop_and_resize_pyramid(frames, boxes, valid, 64)
    want = crop_and_resize_plain(levels, boxes, valid, 64)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
    assert (got[~valid] == 0).all()
    # the plain version on the card equals the plain version on the CPU
    cpu = crop_and_resize_plain([l.cpu() for l in levels], boxes.cpu(), valid.cpu(), 64)
    torch.testing.assert_close(want.cpu(), cpu, atol=0, rtol=0)


def _edge_boxes(h, w):
    """Boxes at every frame edge, sub-pixel boxes, and extents on both sides
    of EXACT_EXTENT * 4^k (the pyramid's level thresholds) that fit the
    frame, along x and along y."""
    pool = [
        (0, 0, 50, 40), (w - 60, 0, w, 30), (0, h - 25, 33, h), (w - 70, h - 80, w, h),
        (0, 0, w, h), (-4.5, -3.25, 20.5, 9.75), (w - 9.5, h - 7.25, w + 3.0, h + 2.0),
        (100.3, 200.6, 100.9, 201.2), (w / 2 + 0.5, h / 2 + 0.25, w / 2 + 0.75, h / 2 + 0.5),
    ]
    for k in range(4):
        for e in (EXACT_EXTENT * 4 ** k, EXACT_EXTENT * 4 ** k + 1):
            if 10 + e <= w:
                pool.append((10.7, 20.2, 10.7 + e, 60.9))
            if 5 + e <= h:
                pool.append((30.1, 5.0, 80.6, 5.0 + e))
    return pool


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 17])
@pytest.mark.parametrize("out_size", [64, 7])
@pytest.mark.parametrize("mode", ["dense", "pyramid"])
def test_roi_kernel_edge_boxes(cuda, d, out_size, mode):
    """Edge, sub-pixel and level-threshold boxes; D=17 and S=7 put ROI
    starts off 16-byte boundaries (the kernel's scalar head and tail).
    Tolerance 1e-3 of 255, 0 expected."""
    h, w = 1080, 1920
    pool = _edge_boxes(h, w)
    b = -(-len(pool) // d)
    gen = torch.Generator(device=cuda).manual_seed(d * 100 + out_size)
    frames = torch.randint(0, 256, (b, h, w, 3), generator=gen, device=cuda, dtype=torch.uint8)
    flat = [pool[i % len(pool)] for i in range(b * d)]
    boxes = torch.tensor(flat, dtype=torch.float32, device=cuda).reshape(b, d, 4)
    valid = (torch.arange(b * d, device=cuda) % 5 != 4).reshape(b, d)
    levels = [frames] if mode == "dense" else build_pyramid(frames, len(pyramid_scales(h, w)))
    got = roi_crop_cuda(levels, boxes, valid, out_size, EXACT_EXTENT, mode)
    want = crop_and_resize_plain(levels, boxes, valid, out_size)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
    assert (got[~valid] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 17])
@pytest.mark.parametrize("out_size", [64, 7])
def test_roi_kernel_round_bf16_mode(cuda, d, out_size):
    """The dense crop's bf16 rounding mode (a bf16 pipeline's) on the edge
    boxes, against the plain version in the same mode; the two modes
    differ."""
    h, w = 1080, 1920
    pool = _edge_boxes(h, w)
    b = -(-len(pool) // d)
    gen = torch.Generator(device=cuda).manual_seed(d * 10 + out_size)
    frames = torch.randint(0, 256, (b, h, w, 3), generator=gen, device=cuda, dtype=torch.uint8)
    flat = [pool[i % len(pool)] for i in range(b * d)]
    boxes = torch.tensor(flat, dtype=torch.float32, device=cuda).reshape(b, d, 4)
    valid = (torch.arange(b * d, device=cuda) % 5 != 4).reshape(b, d)
    got = roi_crop_cuda([frames], boxes, valid, out_size, EXACT_EXTENT, "dense", True)
    want = crop_and_resize_plain([frames], boxes, valid, out_size, round_bf16=True)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
    f32 = roi_crop_cuda([frames], boxes, valid, out_size, EXACT_EXTENT, "dense")
    assert (f32 != got).any()
    via_op = crop_and_resize(frames, boxes, valid, out_size, compute_dtype=torch.bfloat16)
    assert torch.equal(via_op, got)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 17])
@pytest.mark.parametrize("out_size", [64, 7])
def test_roi_kernel_pyramid_round_bf16_mode(cuda, d, out_size):
    """The pyramid crop's bf16 rounding mode (a bf16 pipeline's with
    roi_impl="pallas") on the edge and level-threshold boxes, against the
    plain version in the same mode over the same levels; tolerance 1e-3 of
    255, 0 expected; the float32 mode differs."""
    h, w = 1080, 1920
    pool = _edge_boxes(h, w)
    b = -(-len(pool) // d)
    gen = torch.Generator(device=cuda).manual_seed(d * 7 + out_size)
    frames = torch.randint(0, 256, (b, h, w, 3), generator=gen, device=cuda, dtype=torch.uint8)
    flat = [pool[i % len(pool)] for i in range(b * d)]
    boxes = torch.tensor(flat, dtype=torch.float32, device=cuda).reshape(b, d, 4)
    valid = (torch.arange(b * d, device=cuda) % 5 != 4).reshape(b, d)
    levels = build_pyramid(frames, len(pyramid_scales(h, w)))
    before = launch_counts()
    got = roi_crop_cuda(levels, boxes, valid, out_size, EXACT_EXTENT, "pyramid", True)
    after = launch_counts()
    # the bf16 mode counts under its own key, the float32 mode's untouched
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n == "roi_crop_pyramid_bf16") for n in after}
    want = crop_and_resize_plain(levels, boxes, valid, out_size, round_bf16=True)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
    assert (got[~valid] == 0).all()
    f32 = roi_crop_cuda(levels, boxes, valid, out_size, EXACT_EXTENT, "pyramid")
    assert (f32 != got).any()
    via_op = crop_and_resize_pyramid(frames, boxes, valid, out_size, compute_dtype=torch.bfloat16)
    assert torch.equal(via_op, got)


@pytest.mark.gpu
@pytest.mark.parametrize("out_size", [64, 7])
def test_roi_kernel_all_invalid_batch(cuda, out_size):
    gen = torch.Generator(device=cuda).manual_seed(out_size)
    frames, boxes, _ = _roi_inputs(gen, 3, 5, 480, 640, cuda)
    valid = torch.zeros((3, 5), dtype=torch.bool, device=cuda)
    for out in (crop_and_resize(frames, boxes, valid, out_size),
                crop_and_resize_pyramid(frames, boxes, valid, out_size)):
        assert out.shape == (3, 5, out_size, out_size, 3)
        assert (out == 0).all()


@pytest.mark.gpu
def test_roi_kernel_empty_budget(cuda):
    frames = torch.zeros((2, 32, 32, 3), dtype=torch.uint8, device=cuda)
    out = crop_and_resize(frames, torch.zeros((2, 0, 4), device=cuda),
                          torch.zeros((2, 0), dtype=torch.bool, device=cuda), 64)
    assert out.shape == (2, 0, 64, 64, 3)


@pytest.mark.gpu
def test_pipeline_on_the_card_launches_both_kernels(cuda):
    import dataclasses

    from litepi_tpu_torch.core.types import DetectorConfig, NMSConfig, PipelineConfig
    from litepi_tpu_torch.pipeline import TwoStagePipeline

    cfg = PipelineConfig(
        detector=DetectorConfig(
            name="tiny", base_channels=(32, 64, 128, 256, 512), input_size=160
        ),
        nms=NMSConfig(max_candidates=128, max_detections=8, min_area=4.0),
        num_classifier_classes=10,
        det_input_size=160,
    )
    frames = torch.randint(0, 256, (2, 200, 300, 3), dtype=torch.uint8)
    reset_launch_counts()
    for roi_impl in ("dense", "pallas"):
        pipe = TwoStagePipeline.initialize(
            dataclasses.replace(cfg, roi_impl=roi_impl), device=cuda
        )
        out = pipe.run_fused(frames, 0.001)
        assert out["boxes"].is_cuda and out["cls_probs"].shape == (2, 8, 10)
    counts = launch_counts()
    # 200x300 frames are letterboxed: the stem kernel takes canvas sizes only
    assert counts == {"nms_suppress": 2, "roi_crop_dense": 1, "roi_crop_pyramid": 1,
                      "roi_crop_pyramid_bf16": 0, "stem": 0, "silu_bf16": 0,
                      "sigmoid_bf16": 0, "silu_bf16_bwd": 0, "sigmoid_bf16_bwd": 0}


def _small_cfg(**kw):
    import dataclasses

    from litepi_tpu_torch.core.types import DetectorConfig, NMSConfig, PipelineConfig

    cfg = PipelineConfig(
        detector=DetectorConfig(
            name="tiny", base_channels=(32, 64, 128, 256, 512), input_size=160
        ),
        nms=NMSConfig(max_candidates=128, max_detections=8, min_area=4.0),
        num_classifier_classes=10,
        det_input_size=160,
    )
    return dataclasses.replace(cfg, **kw)


@pytest.mark.gpu
def test_pipeline_on_canvas_sized_frames_launches_all_three_kernels(cuda):
    from litepi_tpu_torch.pipeline import TwoStagePipeline

    pipe = TwoStagePipeline.initialize(_small_cfg(), dtype=torch.bfloat16, device=cuda)
    frames = torch.randint(0, 256, (3, 160, 160, 3), dtype=torch.uint8, device=cuda)
    reset_launch_counts()
    out = pipe.run_fused(frames, 0.001)
    torch.cuda.synchronize()
    assert out["valid"].shape == (3, 8)
    counts = launch_counts()
    # the bf16 detector's SiLUs go through the activation kernel
    assert counts.pop("silu_bf16") > 0
    assert counts == {"nms_suppress": 1, "roi_crop_dense": 1, "roi_crop_pyramid": 0,
                      "roi_crop_pyramid_bf16": 0, "stem": 1, "sigmoid_bf16": 0,
                      "silu_bf16_bwd": 0, "sigmoid_bf16_bwd": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(160, 160), (200, 300)])
def test_run_fused_does_not_synchronise(cuda, hw):
    """On device frames and a device area_scale, run_fused (after its
    first call per frame size) issues its work without one stream or
    device synchronisation, with both budgets on."""
    from litepi_tpu_torch.pipeline import TwoStagePipeline

    pipe = TwoStagePipeline.initialize(
        _small_cfg(crop_det_budget=4, cls_crop_budget=5), dtype=torch.bfloat16, device=cuda
    )
    frames = torch.randint(0, 256, (3, *hw, 3), dtype=torch.uint8, device=cuda)
    area = torch.ones(3, device=cuda)
    want = pipe.run_fused(frames, 0.001, area)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = pipe.run_fused(frames, 0.001, area)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _within_bf16_ulp(got, want):
    """|got - want| within one bf16 ulp of the larger magnitude, or 1e-5
    below 2^-10 where float32 sum noise (~1e-6) is larger than an ulp."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    ulp = torch.ldexp(torch.ones_like(g), e - 8).clamp(min=1e-5)
    return bool(((g - w).abs() <= ulp).all())


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("c", [16, 32, 64, 24, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_kernel_matches_plain(cuda, monkeypatch, b, c, dtype):
    """float32 within 1e-4 (tests/test_pallas_stem.py's tolerance: two sums
    of 27 products in other orders), bfloat16 within one ulp; TF32 off for
    the plain version's convolution.  C=24 takes one 16-channel chunk and a
    plain tail, C=3 the plain loop only."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    gen = torch.Generator(device=cuda).manual_seed(b * 100 + c)
    frames = torch.randint(0, 256, (b, 160, 240, 3), generator=gen, device=cuda,
                           dtype=torch.uint8)
    kernel = torch.randn((3, 3, 3, c), generator=gen, device=cuda) / (255 * 27 ** 0.5)
    bias = torch.randn(c, generator=gen, device=cuda) * 0.1
    params = pack_stem_params(kernel.reshape(27, c), bias)
    before = LAUNCHES["stem"]
    got = fused_stem(frames, kernel, bias, dtype, params)
    assert LAUNCHES["stem"] == before + 1
    want = stem_plain(frames, kernel, bias, dtype)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b, 80, 120, c) and got.dtype == dtype
    assert got.permute(0, 3, 1, 2).is_contiguous()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:  # each step rounds as the plain version's: bit-equal
        assert torch.equal(got, want)
    # the plain version on the card agrees with the plain version on the CPU
    # as closely (their float32 sums round differently, too)
    cpu = stem_plain(frames.cpu(), kernel.cpu(), bias.cpu(), dtype)
    if dtype == torch.float32:
        torch.testing.assert_close(want.cpu(), cpu, atol=1e-4, rtol=0)
    else:
        assert _within_bf16_ulp(want.cpu(), cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("h", [2, 6, 80])
@pytest.mark.parametrize("w", [2, 10, 642])
@pytest.mark.parametrize("c", [16, 32, 3, 20, 256])
def test_stem_kernel_tile_and_pair_edges(cuda, monkeypatch, h, w, c):
    """Heights and widths at the kernel's tile edges (W=642: an odd output
    width of 321, so bf16x2 pairs would straddle rows), C=16 and 32 on the
    weights-as-parameters path and 3, 20, 256 on the generic one; random,
    all-0 and all-255 frames; float32 within 1e-4, bfloat16 within one
    ulp of the plain version."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    gen = torch.Generator(device=cuda).manual_seed(h * 1000 + w * 10 + c)
    kernel = torch.randn((3, 3, 3, c), generator=gen, device=cuda) / (255 * 27 ** 0.5)
    bias = torch.randn(c, generator=gen, device=cuda) * 0.1
    params = pack_stem_params(kernel.reshape(27, c), bias)
    fills = [torch.randint(0, 256, (2, h, w, 3), generator=gen, device=cuda,
                           dtype=torch.uint8)]
    fills += [torch.full((2, h, w, 3), v, dtype=torch.uint8, device=cuda) for v in (0, 255)]
    for frames in fills:
        for dtype in (torch.float32, torch.bfloat16):
            got = stem_cuda(frames, kernel.reshape(27, c), bias, dtype, params)
            want = stem_plain(frames, kernel, bias, dtype).permute(0, 3, 1, 2)
            torch.cuda.synchronize()
            assert got.shape == want.shape == (2, c, h // 2, w // 2)
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
            else:
                assert _within_bf16_ulp(got, want)


@pytest.mark.gpu
def test_stem_kernel_params_are_the_packed_weights(cuda):
    """For C = 16 and 32 the kernel reads its weights from ``params`` alone:
    a call without them, or with parameters of the wrong shape, type or
    device, is refused before any launch (packing in the wrapper would
    copy from the card)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    frames = torch.randint(0, 256, (2, 80, 160, 3), generator=gen, device=cuda,
                           dtype=torch.uint8)
    before = LAUNCHES["stem"]
    for c in (16, 32):
        weight = torch.randn((27, c), generator=gen, device=cuda) / 1000
        bias = torch.randn(c, generator=gen, device=cuda)
        params = pack_stem_params(weight, bias)
        with pytest.raises(ValueError, match="params"):
            stem_cuda(frames, weight, bias, torch.float32)
        for bad in (params[:27], params.double(), params.to(cuda), params.t().contiguous()):
            with pytest.raises(ValueError, match="params"):
                stem_cuda(frames, weight, bias, torch.float32, bad)
    assert LAUNCHES["stem"] == before


@pytest.mark.gpu
def test_stem_kernel_rejects_wrong_inputs_on_the_card(cuda):
    frames = torch.zeros((1, 80, 80, 3), dtype=torch.uint8, device=cuda)
    weight = torch.zeros((27, 16), device=cuda)
    bias = torch.zeros(16, device=cuda)
    with pytest.raises(ValueError, match="weight"):
        stem_cuda(frames, weight.half(), bias, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        stem_cuda(frames, weight, bias.cpu(), torch.float32)
    with pytest.raises(ValueError, match="C="):
        stem_cuda(frames, torch.zeros((27, 300), device=cuda), torch.zeros(300, device=cuda),
                  torch.float32)
    with pytest.raises(ValueError, match="not supported"):
        fused_stem(frames[:, :40], weight.reshape(3, 3, 3, 16), bias)


# ---- the bf16 SiLU / sigmoid kernel ------------------------------------


def test_act_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="bf16 CUDA"):
        act_bf16_cuda(torch.zeros(8, dtype=torch.bfloat16), True)
    with pytest.raises(ValueError, match="bf16 CUDA"):
        act_bf16_cuda(torch.zeros(8), False)


@pytest.mark.gpu
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("case", ["contiguous", "channels_last", "odd", "unaligned", "strided"])
def test_act_kernel_bit_equal_to_plain(cuda, silu, case):
    """Each of the five (four) steps rounds as the plain version's: the
    kernel equals it on every element, on the vector path, the scalar tail
    (1001 values), an unaligned view and a strided one; the result keeps
    the input's shape and dense layout."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = (torch.randn((4, 32, 40, 40), generator=gen, device=cuda) * 4).bfloat16()
    if case == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    elif case == "odd":
        x = x.reshape(-1)[:1001]
    elif case == "unaligned":
        x = x.reshape(-1)[1:4097]
    elif case == "strided":
        x = x[:, ::2]
    before = LAUNCHES["silu_bf16" if silu else "sigmoid_bf16"]
    got = (act.silu if silu else act.sigmoid)(x)
    assert LAUNCHES["silu_bf16" if silu else "sigmoid_bf16"] == before + 1
    want = (act.silu_bf16_plain if silu else act.sigmoid_bf16_plain)(x)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    if case == "channels_last":
        assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)
    # float32 takes torch's own op and launches nothing
    assert torch.equal((act.silu if silu else act.sigmoid)(x.float()),
                       torch.nn.functional.silu(x.float()) if silu else torch.sigmoid(x.float()))
    assert LAUNCHES["silu_bf16" if silu else "sigmoid_bf16"] == before + 1


def test_act_backward_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 CUDA"):
        act_bf16_backward_cuda(x, x, True)


@pytest.mark.gpu
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("case", ["contiguous", "channels_last", "odd", "unaligned", "strided"])
def test_act_backward_kernel_bit_equal_to_plain(cuda, silu, case):
    """The backward mode rounds each op of ``jax.vjp`` as the plain
    version's: through autograd on the card, the gradient equals
    ``silu_bf16_grad_plain`` / ``sigmoid_bf16_grad_plain`` on every
    element, on the vector path, the scalar tail, an unaligned view and a
    strided one (and an output gradient of another layout); one launch of
    the backward mode per backward, none of it without autograd."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = (torch.randn((4, 32, 40, 40), generator=gen, device=cuda) * 4).bfloat16()
    if case == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    elif case == "odd":
        x = x.reshape(-1)[:1001]
    elif case == "unaligned":
        x = x.reshape(-1)[1:4097]
    elif case == "strided":
        x = x[:, ::2]
    g = torch.randn(x.shape, generator=gen, device=cuda).bfloat16()
    if case == "contiguous":
        g = g.contiguous(memory_format=torch.channels_last)
    key = "silu_bf16_bwd" if silu else "sigmoid_bf16_bwd"
    before = LAUNCHES[key]
    xt = x.detach().clone().requires_grad_(True)
    (act.silu if silu else act.sigmoid)(xt).backward(g)
    assert LAUNCHES[key] == before + 1
    want = (act.silu_bf16_grad_plain if silu else act.sigmoid_bf16_grad_plain)(x, g)
    direct = act_bf16_backward_cuda(x, g, silu)
    torch.cuda.synchronize()
    assert xt.grad.dtype == torch.bfloat16 and xt.grad.shape == x.shape
    assert torch.equal(xt.grad, want) and torch.equal(direct, want)
    with torch.no_grad():
        (act.silu if silu else act.sigmoid)(x)
    assert LAUNCHES[key] == before + 2


@pytest.mark.gpu
def test_train_step_launches_the_act_kernel_both_ways(cuda):
    """A bf16 detector train step on the card runs the SiLU forward and its
    backward mode, and its float32 master weights stay float32."""
    from litepi_tpu_torch.core.types import ablation_configs
    from litepi_tpu_torch.train import create_detector_train_state, detector_train_step

    import dataclasses

    cfg = dataclasses.replace(ablation_configs(width_scales=(0.25,), extra=())[0], input_size=128)
    model, state, tx = create_detector_train_state(cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    batch = {"images": torch.rand(2, 3, 128, 128, generator=gen, device=cuda),
             "gt_boxes": torch.tensor([[[10.0, 10.0, 60.0, 50.0]]] * 2, device=cuda),
             "gt_labels": torch.zeros(2, 1, dtype=torch.int32, device=cuda),
             "gt_mask": torch.ones(2, 1, dtype=torch.bool, device=cuda)}
    reset_launch_counts()
    _, m = detector_train_step(model, tx, state, batch, cfg=cfg)
    counts = launch_counts()
    assert counts["silu_bf16"] > 0 and counts["silu_bf16_bwd"] == counts["silu_bf16"]
    assert bool(torch.isfinite(m["loss"]))
    assert all(p.dtype == torch.float32 for p in model.parameters())


# ---- the baseline detectors (Faster R-CNN, SSD300) on the card ---------


@pytest.mark.gpu
def test_rpn_nms_on_its_own_candidates_bit_equal(cuda):
    """Faster R-CNN's RPN at 640 (B=2, 1,024 candidates of 1 class) runs
    the NMS kernel; on the candidates it was given, the keep mask equals
    ``suppress_sorted`` bit for bit, and so does the final class-aware
    NMS's at K=256."""
    from litepi_tpu_torch.models import faster_rcnn as frcnn_mod
    from litepi_tpu_torch.ops import nms as nms_ops
    from litepi_tpu_torch.train.baselines import create_baseline_train_state

    state, _ = create_baseline_train_state("faster_rcnn", 2, 640, seed=0, dtype=torch.float32,
                                           device=cuda)
    x = torch.rand(2, 3, 640, 640, generator=torch.Generator(device=cuda).manual_seed(1),
                   device=cuda)
    calls = []

    def recorder(module):
        real = module.suppress

        def record(boxes, valid, cls, thr):
            calls.append((boxes.clone(), valid.clone(), cls.clone(), thr))
            return real(boxes, valid, cls, thr)
        return real, record

    real_rpn, module_rpn = recorder(frcnn_mod)
    real_final, module_final = recorder(nms_ops)
    frcnn_mod.suppress, nms_ops.suppress = module_rpn, module_final
    reset_launch_counts()
    try:
        with torch.no_grad():
            out = state.model.eval()(x)
            frcnn_mod.postprocess_detections(out, 640)
    finally:
        frcnn_mod.suppress, nms_ops.suppress = real_rpn, real_final
    assert launch_counts()["nms_suppress"] == 2
    assert [tuple(c[0].shape) for c in calls] == [(2, 1024, 4), (2, 256, 4)]
    for boxes, valid, cls, thr in calls:
        got = nms_suppress_cuda(boxes, cls.to(torch.int32), valid, thr)
        assert bool(valid.any()) and torch.equal(got, suppress_sorted(boxes, valid, cls, thr))


class _ProposalChoices:
    """Stands in for ``topk_stable`` and ``suppress`` in
    ``models.faster_rcnn``: records a forward's choices (its two top-k picks
    and its RPN keep mask) or, given another forward's, takes those, its
    scores gathered at the given picks; ``gaps`` holds, per top-k, the
    largest difference at a rank between the given picks' scores and its
    own top-k's."""

    def __init__(self, given=None):
        self.given, self.chosen, self.gaps = given, [], []

    def _choose(self, own):
        self.chosen.append(own.detach().cpu())
        return own if self.given is None else self.given[len(self.chosen) - 1].to(own.device)

    def __enter__(self):
        import litepi_tpu_torch.models.faster_rcnn as frcnn_mod

        self.module, self.real = frcnn_mod, (frcnn_mod.topk_stable, frcnn_mod.suppress)
        real_topk, real_suppress = self.real

        def topk(x, k):
            values, idx = real_topk(x, k)
            picks = self._choose(idx)
            if picks is idx:
                return values, idx
            taken = torch.gather(x, 1, picks)
            fin = torch.isfinite(values)
            assert torch.equal(fin, torch.isfinite(taken))
            self.gaps.append(float((taken[fin].double() - values[fin].double()).abs().max()))
            return taken, picks

        frcnn_mod.topk_stable = topk
        frcnn_mod.suppress = lambda *a: self._choose(real_suppress(*a))
        return self

    def __exit__(self, *exc):
        self.module.topk_stable, self.module.suppress = self.real


@pytest.mark.gpu
@pytest.mark.parametrize("arch,size", [("faster_rcnn", 320), ("ssd300", 300)])
def test_baseline_train_step_card_vs_cpu(cuda, arch, size):
    """One train step of each baseline at B=2 on the card and on the CPU
    from the same weights, batch and sampling draws, in float64 (in
    float32 the step's gradient is in part rounding noise, up to 68% of a
    leaf's scale for Faster R-CNN, tests/test_torch_faster_rcnn.py), the
    CPU's forward on the card's proposal choices (near-tie objectness
    scores may pick either of two candidates; each of the card's picks
    scores within ``2 * eps`` of the CPU's own top-k at its rank, ``eps``
    the largest objectness difference, as two exact top-k selections
    obey): the loss within 1e-5 relative, the parameters after it within
    1e-5 (``|card - cpu| / (1 + |cpu|)``)."""
    from litepi_tpu_torch.train.baselines import baseline_loss, create_baseline_train_state

    gen = torch.Generator().manual_seed(2)
    images = torch.rand(2, 3, size, size, generator=gen, dtype=torch.float64)
    xy = torch.rand(2, 4, 2, generator=gen, dtype=torch.float64) * size * 0.6
    boxes = torch.cat([xy, xy + 8 + torch.rand(2, 4, 2, generator=gen, dtype=torch.float64)
                       * size * 0.3], -1)
    batch = {"images": images, "gt_boxes": boxes,
             "gt_labels": torch.zeros(2, 4, dtype=torch.int32),
             "gt_mask": torch.tensor([[True, True, True, False], [True, False, False, False]])}
    n_anchors = sum(3 * (size // s) ** 2 for s in (4, 8, 16, 32, 64))
    draws = [torch.rand(shape, generator=gen, dtype=torch.float64)
             for shape in ((2, n_anchors),) * 2 + ((2, 256),) * 2]
    runs, card = [], _ProposalChoices()
    for dev, choices in ((cuda, card), (torch.device("cpu"), _ProposalChoices(card.chosen))):
        state, tx = create_baseline_train_state(arch, 1, size, seed=3, dtype=torch.float64,
                                                device=dev)
        state.model.double()
        d = [t.to(dev) for t in draws] if arch == "faster_rcnn" else None
        with choices:
            loss, _, out = baseline_loss(state, {k: v.to(dev) for k, v in batch.items()}, d)
        params = list(state.model.parameters())
        tx.update_(params, torch.autograd.grad(loss, params), state.opt_state, 0)
        runs.append((float(loss.detach()),
                     {k: p.detach().cpu() for k, p in state.model.named_parameters()},
                     out.get("rpn_obj")))
    (l_dev, p_dev, obj_dev), (l_cpu, p_cpu, obj_cpu) = runs
    if arch == "faster_rcnn":
        eps = float((obj_dev.detach().cpu().double() - obj_cpu.detach().double()).abs().max())
        assert len(choices.gaps) == 2 and max(choices.gaps) <= 2 * eps, (choices.gaps, eps)
    assert abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu)
    for k in p_cpu:
        assert float(((p_dev[k] - p_cpu[k]).abs() / (1 + p_cpu[k].abs())).max()) <= 1e-5, k
