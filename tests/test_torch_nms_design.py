"""The NMS kernel's algorithm (litepi_tpu_torch/csrc/nms.cu) transcribed
into numpy and held bit-equal to the Pallas kernel in interpret mode and to
the port's plain version (suppress_sorted) on the CPU.

The transcription follows the kernel's two designs step by step:

* K <= 64 (nms_small_kernel): lane l of warp w computes rows l and 63 - l
  over its warp's run of the row pair's 63 pairs; the warps' partial words
  are ORed; the greedy pass runs on the one word.
* K > 64 (nms_mask_kernel): 64 x 64 tiles of the upper triangle, walked
  by a grid-stride loop whose tile index is decoded in closed form (every
  tile once, at any grid), one word per suppressor row (the kernel gives
  each row two threads of 32 columns, which only divides the work),
  computed only for valid rows and up to the tile's last valid column,
  tiles with no valid column skipped, rows past K not written; the
  scratch buffer starts as random bits (what the kernel never writes must
  never decide a bit).  Then the word-by-word greedy pass:
  - K <= 1024 (nms_greedy_kernel): the removed set held one word per lane;
  - K > 1024 (nms_greedy_large_kernel): the removed set in shared memory:
    warp 0 decides word w on the diagonal tile's row words, and warp v ORs
    the kept rows' words of columns w + 1 + v, w + 1 + v + LARGE_WARPS, ...
    into the removed set, reading only kept rows' words.
"""

import numpy as np
import pytest
import torch

from litepi_tpu.ops.pallas_nms import pallas_suppress
from litepi_tpu_torch.ops.nms import suppress_sorted

FUSED_MAX_K = 64  # nms.cu's kSmallMaxK
SMALL_WARPS = 4  # nms.cu's kSmallWarps
SHARED_MAX_WORDS = 16  # nms.cu's kSharedMaxWords
LARGE_WARPS = 16  # nms.cu's kLargeWarps
MAX_GRID_Y = 65535  # nms.cu's kMaxGridY
ALL = np.uint64(0xFFFFFFFFFFFFFFFF)


def _inter_union(a, c):
    """Float32 (inter, union), each (len(a), len(c)), of row boxes a and
    column boxes c in the kernel's (and the Pallas kernel's) order of
    operations."""
    f32 = np.float32
    a, c = a[:, None, :], c[None, :, :]
    area_a = np.maximum(a[..., 2] - a[..., 0], f32(0)) * np.maximum(a[..., 3] - a[..., 1], f32(0))
    area_c = np.maximum(c[..., 2] - c[..., 0], f32(0)) * np.maximum(c[..., 3] - c[..., 1], f32(0))
    lt_x, lt_y = np.maximum(a[..., 0], c[..., 0]), np.maximum(a[..., 1], c[..., 1])
    rb_x, rb_y = np.minimum(a[..., 2], c[..., 2]), np.minimum(a[..., 3], c[..., 3])
    inter = np.maximum(rb_x - lt_x, f32(0)) * np.maximum(rb_y - lt_y, f32(0))
    uni = area_a + area_c - inter + f32(1e-6)
    assert inter.dtype == uni.dtype == np.float32
    return inter, uni


def _iou(a, c):
    """The Pallas kernel's IoU: one float32 division."""
    inter, uni = _inter_union(a, c)
    with np.errstate(divide="ignore", invalid="ignore"):
        return inter / uni


def _kernel_iou(a, c):
    """The kernel's IoU: the same division, skipped where inter = 0 and the
    union is positive (the quotient is then +-0 exactly)."""
    inter, uni = _inter_union(a, c)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where((inter != 0) | ~(uni > 0), inter / uni, np.float32(0))


def _suppresses(a, c, cls_a, cls_c, thr):
    """Bool (len(a), len(c)): row box a[r] suppresses column box c[q]."""
    return (_kernel_iou(a, c) > np.float32(thr)) & (cls_a[:, None] == cls_c[None, :])


def _pack(bits):
    """Bool (..., n <= 64) -> uint64 words, bit q = column q."""
    n = bits.shape[-1]
    return (bits.astype(np.uint64) << np.arange(n, dtype=np.uint64)).sum(-1, dtype=np.uint64)


def _greedy_word(d, r):
    """The in-word chain: candidates q = 0..63 in order; bit q of r is
    spread over the bits above it, and the row word d[q], cut to its bits
    above q, is ORed in where that spread is clear, so a kept q (bit q
    clear) adds its row and a removed one nothing, whatever its word
    holds."""
    r, full = int(r), int(ALL)
    for q in range(64):
        above = (full << (q + 1)) & full
        spread = r | (above if (r >> q) & 1 else 0)
        r |= int(d[q]) & above & ~spread
    return ~r & full


def _small_kernel(boxes, cls, valid, thr):
    k = len(valid)
    pad = np.zeros((64, 4), np.float32)
    pad[:k] = boxes
    c = np.zeros(64, np.int32)
    c[:k] = cls
    over = _suppresses(pad, pad, c, c, thr)
    run = -(-63 // SMALL_WARPS)
    part = np.zeros((SMALL_WARPS, 64), np.uint64)
    covered = np.zeros((64, 64), int)
    for warp in range(SMALL_WARPS):
        for lane in range(32):
            for t in range(warp * run, min((warp + 1) * run, 63)):
                j, i = (lane, lane + 1 + t) if t < 63 - lane else (63 - lane, t + 1)
                covered[j, i] += 1
                if over[j, i]:
                    part[warp, j] |= np.uint64(1) << np.uint64(i)
    # the row pairs and runs cover each pair j < i exactly once
    np.testing.assert_array_equal(covered, np.triu(np.ones((64, 64), int), 1))
    words = np.bitwise_or.reduce(part, axis=0)
    v = np.zeros(64, bool)
    v[:k] = valid
    kept = _greedy_word(words, ~_pack(v) & ALL)
    return np.array([(kept >> q) & 1 for q in range(k)], bool)


def _tiles_before(r, w_count):
    return r * w_count - r * (r - 1) // 2


def _tile_of(t, w_count):
    """nms_mask_kernel's tile t -> (rb, cb): the float32 estimate of the
    largest r with _tiles_before(r) <= t, then the integer fixes."""
    b = np.float32(2 * w_count + 1)
    arg = b * b - np.float32(8) * np.float32(t)
    rb = int((b - np.sqrt(arg)) * np.float32(0.5))
    while rb > 0 and _tiles_before(rb, w_count) > t:
        rb -= 1
    while _tiles_before(rb + 1, w_count) <= t:
        rb += 1
    return rb, rb + (t - _tiles_before(rb, w_count))


def _tile_order(w_count):
    """The tiles in the order nms_mask_kernel visits them: the grid-stride
    loop over a grid of min(T, MAX_GRID_Y) blocks per image."""
    n_tiles = w_count * (w_count + 1) // 2
    grid_y = min(n_tiles, MAX_GRID_Y)
    return [_tile_of(t, w_count) for y in range(grid_y) for t in range(y, n_tiles, grid_y)]


def _greedy_shared(mask, valid_words, w_count, k):
    """nms_greedy_kernel (W <= 16): lane c holds word c of the removed set."""
    removed = np.zeros(w_count, np.uint64)
    keep = np.zeros(k, bool)
    for w in range(w_count):
        r = removed[w] | (~valid_words[w] & ALL)
        kept = _greedy_word(mask[w, 64 * w : 64 * w + 64], r)
        qs = [q for q in range(64) if (kept >> q) & 1]
        keep[[64 * w + q for q in qs]] = True
        for c in range(w + 1, w_count):
            removed[c] |= np.bitwise_or.reduce(mask[c, [64 * w + q for q in qs]]) if qs else 0
    return keep


def _greedy_large(mask, valid_words, w_count, k):
    """nms_greedy_large_kernel (W > 16): the removed set in shared memory,
    the invalid candidates set from the start; warp 0 decides word w, then
    each warp ORs its columns' words of the kept rows (lane l: rows 64w + l
    and 64w + 32 + l, a row's load skipped unless it is kept) across its
    lanes into the removed set."""
    s_removed = ~valid_words & ALL
    keep = np.zeros(k, bool)
    for w in range(w_count):
        kept = _greedy_word(mask[w, 64 * w : 64 * w + 64], s_removed[w])
        for lane in range(32):
            for q in (lane, lane + 32):
                if 64 * w + q < k:
                    keep[64 * w + q] = bool((kept >> q) & 1)
        if kept == 0:
            continue
        for warp in range(LARGE_WARPS):
            for c in range(w + 1 + warp, w_count, LARGE_WARPS):
                x = np.uint64(0)
                for lane in range(32):
                    for q in (lane, lane + 32):
                        if (kept >> q) & 1:
                            x |= mask[c, 64 * w + q]
                s_removed[c] |= x
    return keep


def _two_kernels(boxes, cls, valid, thr, rng):
    k = len(valid)
    w_count = -(-k // 64)
    kp = 64 * w_count
    half = (w_count, kp)
    mask = (rng.integers(0, 2**32, half, dtype=np.uint64) << np.uint64(32)) | rng.integers(
        0, 2**32, half, dtype=np.uint64)
    valid_words = (rng.integers(0, 2**32, w_count, dtype=np.uint64) << np.uint64(32)) | \
        rng.integers(0, 2**32, w_count, dtype=np.uint64)
    order = _tile_order(w_count)
    assert sorted(order) == [(rb, cb) for rb in range(w_count) for cb in range(rb, w_count)]
    for rb, cb in order:
        rows = np.arange(rb * 64, min(rb * 64 + 64, k))
        if cb == rb:  # the diagonal tile writes the row block's valid bits
            valid_words[rb] = _pack(valid[rows])
        cols = np.arange(cb * 64, min(cb * 64 + 64, k))
        if not valid[cols].any():
            continue  # the tile returns at once
        n = int(np.nonzero(valid[cols])[0][-1]) + 1
        over = _suppresses(boxes[rows], boxes[cols[:n]], cls[rows], cls[cols[:n]], thr)
        over &= valid[rows][:, None]  # an invalid row computes nothing
        if cb == rb:
            over &= rows[:, None] < cols[None, :n]
        mask[cb, rows] = _pack(over)
    greedy = _greedy_shared if w_count <= SHARED_MAX_WORDS else _greedy_large
    return greedy(mask, valid_words, w_count, k)


def transcription(boxes, cls, valid, thr, seed=0):
    """The kernel's keep mask (B, K) for numpy inputs, by its design for K."""
    rng = np.random.default_rng(seed)
    k = boxes.shape[1]
    run = _small_kernel if k <= FUSED_MAX_K else (
        lambda *a: _two_kernels(*a, rng))
    return np.stack([run(boxes[b], cls[b], valid[b], thr) for b in range(len(boxes))])


def _inputs(rng, b, k, num_classes, valid_prefix=True):
    """Score-ordered candidates crowded so that suppression chains form;
    valid is a prefix (scores over a conf threshold) or random."""
    xy = rng.uniform(0, 300, (b, k, 2))
    wh = rng.uniform(4, 150, (b, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    cls = np.minimum(rng.geometric(0.3, (b, k)) - 1, num_classes - 1).astype(np.int32)
    if valid_prefix:
        n_valid = rng.integers(k // 2, k + 1, (b, 1))
        valid = np.arange(k)[None, :] < n_valid
    else:
        valid = rng.uniform(size=(b, k)) < 0.8
    return boxes, cls, valid


def _all_three(boxes, cls, valid, thr):
    """(transcription, Pallas interpret, suppress_sorted) keep masks."""
    got = transcription(boxes, cls, valid, thr)
    pallas = np.asarray(pallas_suppress(
        np.swapaxes(boxes, -1, -2), cls.astype(np.float32)[:, None, :], valid, thr, True))
    plain = suppress_sorted(torch.from_numpy(boxes), torch.from_numpy(valid),
                            torch.from_numpy(cls), thr).numpy()
    return got, pallas, plain


@pytest.mark.parametrize("num_classes", [1, 3, 91])
@pytest.mark.parametrize("k", [1, 63, 64, 65, 128, 512, 1024, 1025, 2048])
def test_transcription_bit_equal(k, num_classes):
    rng = np.random.default_rng(k * 10 + num_classes)
    boxes, cls, valid = _inputs(rng, 2, k, num_classes, valid_prefix=k % 2 == 0)
    got, pallas, plain = _all_three(boxes, cls, valid, 0.45)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, plain)
    if k >= 128 or (k > 1 and num_classes < 91):  # suppresses, and keeps
        assert 0 < got.sum() < valid.sum()


@pytest.mark.parametrize("k", [64, 65, 512])
def test_transcription_all_invalid(k):
    boxes, cls, _ = _inputs(np.random.default_rng(k), 2, k, 1)
    valid = np.zeros((2, k), bool)
    got, pallas, plain = _all_three(boxes, cls, valid, 0.45)
    assert not got.any() and not pallas.any() and not plain.any()


@pytest.mark.parametrize("k", [64, 65, 512])
def test_transcription_identical_boxes(k):
    """Every box the same: the first valid one survives."""
    boxes = np.tile(np.array([10, 20, 60, 90], np.float32), (2, k, 1))
    cls = np.zeros((2, k), np.int32)
    valid = np.ones((2, k), bool)
    valid[1, :3] = False
    got, pallas, plain = _all_three(boxes, cls, valid, 0.45)
    want = np.zeros((2, k), bool)
    want[0, 0] = want[1, 3] = True
    for mask in (got, pallas, plain):
        np.testing.assert_array_equal(mask, want)


@pytest.mark.parametrize("k", [64, 130, 1024, 1100])
def test_transcription_long_chain(k):
    """1 class, each box overlapping only the next (IoU 12/20 > 0.45; the
    one after next 8/24): every other box is kept, a chain of k decisions
    across every word."""
    x = np.arange(k, dtype=np.float32) * 4
    boxes = np.stack([x, np.zeros(k, np.float32), x + 16, np.full(k, 10, np.float32)], -1)[None]
    cls = np.zeros((1, k), np.int32)
    valid = np.ones((1, k), bool)
    got = transcription(boxes, cls, valid, 0.45)
    np.testing.assert_array_equal(got[0], np.arange(k) % 2 == 0)
    if k <= 1024:  # the plain fixpoint takes k rounds too (25 s at 1,100 here)
        plain = suppress_sorted(torch.from_numpy(boxes), torch.from_numpy(valid),
                                torch.from_numpy(cls), 0.45).numpy()
        np.testing.assert_array_equal(got, plain)
    if k <= 130:  # the Pallas fixpoint takes k rounds of its interpreter here
        pallas = np.asarray(pallas_suppress(
            np.swapaxes(boxes, -1, -2), cls.astype(np.float32)[:, None, :], valid, 0.45, True))
        np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("k", [64, 65, 512])
def test_transcription_at_the_threshold(k):
    """Thresholds equal to IoUs the pairs really have (float32), and the
    float32 just below: iou > thr is false at the first, true at the
    second, for the very same pairs."""
    rng = np.random.default_rng(k + 7)
    boxes, cls, valid = _inputs(rng, 2, k, 1)
    iou = _iou(boxes[0, :8], boxes[0, :8])
    values = iou[np.triu(np.ones((8, 8), bool), 1) & (iou > 0)]
    assert values.size
    for v in values[:4]:
        for thr in (float(v), float(np.nextafter(v, np.float32(0)))):
            got, pallas, plain = _all_three(boxes, cls, valid, thr)
            np.testing.assert_array_equal(got, pallas)
            np.testing.assert_array_equal(got, plain)
            if thr == float(v):  # the pairs at exactly thr are not suppressed
                assert not _suppresses(boxes[0, :8], boxes[0, :8], cls[0, :8], cls[0, :8],
                                       thr)[iou == v].any()


@pytest.mark.parametrize("thr", [0.0, -0.5, 1e-40, 1.0])
def test_transcription_at_other_thresholds(thr):
    """Thresholds where the scaled test does not apply (0, negative,
    subnormal) or every IoU sits below (1.0)."""
    boxes, cls, valid = _inputs(np.random.default_rng(11), 2, 65, 3)
    got, pallas, plain = _all_three(boxes, cls, valid, thr)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("w_count", [2, 16, 17, 33, 132, 361, 362, 400])
def test_strided_tile_order_covers_every_tile_once(w_count):
    """The closed-form decode equals the loop decode at every tile (W = 16
    is K = 1,024, W = 132 is K = 8,400; from W = 362 the tiles outnumber the grid's 65,535
    blocks, so the grid-stride loop visits some blocks' tiles twice over)."""
    n_tiles = w_count * (w_count + 1) // 2
    want = []
    for rb in range(w_count):
        want += [(rb, cb) for cb in range(rb, w_count)]
    got = [_tile_of(t, w_count) for t in range(n_tiles)]
    assert got == want
    order = _tile_order(w_count)
    assert len(order) == n_tiles and sorted(order) == want
