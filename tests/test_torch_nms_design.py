"""The NMS kernel's algorithm (litepi_tpu_torch/csrc/nms.cu) transcribed
into numpy and held bit-equal to the Pallas kernel in interpret mode and to
the port's plain version (suppress_sorted) on the CPU.

The transcription follows the kernel's designs step by step:

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
  never decide a bit).  Then the word-by-word greedy pass, by nms.cu's
  route for (B, K):
  - nms_greedy_kernel: the removed set held one word per lane;
  - nms_greedy_cluster_kernel (above 1,024 candidates, and from 961 at
    B <= 16): a cluster of 8 or 16 blocks, block r owning the columns
    r, r + n, ...; each block a coroutine, the blocks interleaved at
    random; the owner of word w + 1 ORs word w into that column first and
    decides it at once, publishing the keep word into a reused slot of
    every block; the pass stops after the last word with a valid
    candidate.  The segments each block reads, their order, the slots'
    reuse and the order of publication are checked.
"""

import numpy as np
import pytest
import torch

from litepi_tpu.ops.pallas_nms import pallas_suppress
from litepi_tpu_torch.ops.nms import suppress_sorted

FUSED_MAX_K = 64  # nms.cu's kSmallMaxK
SMALL_WARPS = 4  # nms.cu's kSmallWarps
SHARED_MAX_WORDS = 16  # nms.cu's kSharedMaxWords
CLUSTER_MAX_BATCH = 16  # nms.cu's kClusterMaxBatch
CLUSTER_MIN_WORDS = 16  # nms.cu's kClusterMinWords
KEPT_SLOTS = 32  # nms.cu's kKeptSlots
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


def _first_owned(x, rank, n):
    """The smallest column c >= x with c % n == rank."""
    return x + (rank - x % n + n) % n


def _cluster_segments(rank, n, words):
    """The mask segments (column c, word w) block ``rank`` of an n-block
    cluster reads, in order: word 0's diagonal if it owns column 0, then for
    each word w its owned columns c > w ascending, each followed by the
    diagonal (c, c) when c == w + 1.  nms_greedy_cluster_kernel's producer
    lane streams them in this order; its consumer warp reads them so."""
    seq = [(0, 0)] if rank == 0 and words > 0 else []
    for w in range(words - 1):
        for c in range(_first_owned(w + 1, rank, n), words, n):
            seq.append((c, w))
            if c == w + 1:
                seq.append((c, c))
    return seq


def _greedy_cluster(mask, valid_words, w_count, k, n, rng):
    """nms_greedy_cluster_kernel on a cluster of n blocks: block r owns the
    columns c = r, r + n, ... of the removed set (the invalid candidates
    set from the start); the pass stops after the last word with a valid
    candidate.  Each block runs as a coroutine, and the blocks take turns in
    a random order (any interleaving the card may pick), a block pausing
    while the keep word it needs next is unpublished.  On each word w's
    keep word a block ORs the kept rows of its owned columns' segments
    (c, w) into the removed set, in ascending c; the owner of w + 1 ORs
    that column first and decides word w + 1 at once on the diagonal
    segment, then publishes it into slot (w + 1) % KEPT_SLOTS of every
    block.  Checks that every block reads the segments in the order its
    producer streams them, that a slot is never overwritten before its
    block has read it, and that each keep word is published once, in word
    order."""
    valid_nonzero = np.nonzero(valid_words)[0]
    words = int(valid_nonzero[-1]) + 1 if valid_nonzero.size else 0
    keep = np.zeros(k, bool)
    published = {}  # word -> keep word
    waited = [-1] * n  # the last word each block has read
    order = []  # words in the order they were published

    def block(rank):
        removed = {c: ~valid_words[c] & ALL for c in range(rank, w_count, n)}
        read = []  # segments read, in order

        def decide(c):
            read.append((c, c))
            kept = _greedy_word(mask[c, 64 * c : 64 * c + 64], removed[c])
            for q in range(64):
                if 64 * c + q < k:
                    keep[64 * c + q] = bool((kept >> q) & 1)
            if c + 1 < words:  # lanes 0..n-1 publish it to every block
                assert c not in published
                for b in range(n):  # the slot's previous word has been read
                    assert waited[b] >= c - n and waited[b] >= c - KEPT_SLOTS
                published[c] = kept
                order.append(c)

        if rank == 0 and words > 0:
            decide(0)
        for w in range(words - 1):
            while w not in published:
                yield
            kept = published[w]
            waited[rank] = w
            rows = [64 * w + q for q in range(64) if (kept >> q) & 1]
            for c in range(_first_owned(w + 1, rank, n), words, n):
                read.append((c, w))
                if rows:  # rows not kept are not loaded
                    removed[c] |= np.bitwise_or.reduce(mask[c, rows])
                if c == w + 1:
                    decide(c)
        assert read == _cluster_segments(rank, n, words)

    running = {r: block(r) for r in range(n)}
    while running:
        r = list(running)[rng.integers(len(running))]
        try:
            next(running[r])
        except StopIteration:
            del running[r]
    assert order == list(range(words - 1))
    # the words past the last valid candidate: their owners write 0
    assert not keep[64 * words :].any()
    return keep


def greedy_route(batch, k):
    """nms.cu's route(B, K): 0 nms_small_kernel alone, 1 the greedy pass
    of nms_greedy_kernel, 2 that of nms_greedy_cluster_kernel."""
    if k <= FUSED_MAX_K:
        return 0
    w_count = -(-k // 64)
    small = batch <= CLUSTER_MAX_BATCH and w_count >= CLUSTER_MIN_WORDS
    return 2 if w_count > SHARED_MAX_WORDS or small else 1


def _two_kernels(boxes, cls, valid, thr, rng, batch, cluster):
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
    if greedy_route(batch, k) == 1:
        return _greedy_shared(mask, valid_words, w_count, k)
    return _greedy_cluster(mask, valid_words, w_count, k, cluster, rng)


def transcription(boxes, cls, valid, thr, seed=0, cluster=16):
    """The kernel's keep mask (B, K) for numpy inputs, by its design for
    (B, K); ``cluster``: the blocks per cluster of the cluster greedy pass
    (16, or 8 where the card cannot hold B clusters of 16 at once)."""
    rng = np.random.default_rng(seed)
    k = boxes.shape[1]
    run = _small_kernel if k <= FUSED_MAX_K else (
        lambda *a: _two_kernels(*a, rng, len(boxes), cluster))
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


def _transcriptions(boxes, cls, valid, thr):
    """The transcription's keep mask; where the greedy pass runs on a
    cluster, at 8 and at 16 blocks per cluster, which must agree."""
    got = transcription(boxes, cls, valid, thr, cluster=16)
    if greedy_route(*valid.shape) == 2:
        np.testing.assert_array_equal(transcription(boxes, cls, valid, thr, cluster=8), got)
    return got


def _all_three(boxes, cls, valid, thr):
    """(transcription, Pallas interpret, suppress_sorted) keep masks."""
    got = _transcriptions(boxes, cls, valid, thr)
    pallas = np.asarray(pallas_suppress(
        np.swapaxes(boxes, -1, -2), cls.astype(np.float32)[:, None, :], valid, thr, True))
    plain = suppress_sorted(torch.from_numpy(boxes), torch.from_numpy(valid),
                            torch.from_numpy(cls), thr).numpy()
    return got, pallas, plain


@pytest.mark.parametrize("num_classes", [1, 3, 91])
@pytest.mark.parametrize("k", [1, 63, 64, 65, 128, 512, 1024, 1025, 2000, 2048])
def test_transcription_bit_equal(k, num_classes):
    rng = np.random.default_rng(k * 10 + num_classes)
    boxes, cls, valid = _inputs(rng, 2, k, num_classes, valid_prefix=k % 2 == 0)
    got, pallas, plain = _all_three(boxes, cls, valid, 0.45)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, plain)
    if k >= 128 or (k > 1 and num_classes < 91):  # suppresses, and keeps
        assert 0 < got.sum() < valid.sum()


@pytest.mark.parametrize("k", [64, 65, 512, 1100])
def test_transcription_all_invalid(k):
    boxes, cls, _ = _inputs(np.random.default_rng(k), 2, k, 1)
    valid = np.zeros((2, k), bool)
    got, pallas, plain = _all_three(boxes, cls, valid, 0.45)
    assert not got.any() and not pallas.any() and not plain.any()


@pytest.mark.parametrize("k", [64, 65, 512, 1100])
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
    got = _transcriptions(boxes, cls, valid, 0.45)
    np.testing.assert_array_equal(got[0], np.arange(k) % 2 == 0)
    if k <= 1024:  # the plain fixpoint takes k rounds too (25 s at 1,100 here)
        plain = suppress_sorted(torch.from_numpy(boxes), torch.from_numpy(valid),
                                torch.from_numpy(cls), 0.45).numpy()
        np.testing.assert_array_equal(got, plain)
    if k <= 130:  # the Pallas fixpoint takes k rounds of its interpreter here
        pallas = np.asarray(pallas_suppress(
            np.swapaxes(boxes, -1, -2), cls.astype(np.float32)[:, None, :], valid, 0.45, True))
        np.testing.assert_array_equal(got, pallas)


def _xla_greedy(boxes, cls, valid, thr):
    """The greedy keep mask over the suppression relation as XLA's CPU
    computes it from the Pallas kernel's IoU expression (one jitted jnp
    program, as ``pallas_suppress`` runs in interpret mode)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def over(b, c):
        t = lambda a: jnp.swapaxes(a, 1, 2)  # noqa: E731
        x1, y1, x2, y2 = (b[:, None, :, i] for i in range(4))
        inter = (jnp.maximum(jnp.minimum(t(x2), x2) - jnp.maximum(t(x1), x1), 0.0)
                 * jnp.maximum(jnp.minimum(t(y2), y2) - jnp.maximum(t(y1), y1), 0.0))
        area = jnp.maximum(x2 - x1, 0.0) * jnp.maximum(y2 - y1, 0.0)
        iou = inter / (t(area) + area - inter + 1e-6)
        return (iou > thr) & (c[:, :, None] == c[:, None, :])

    o = np.asarray(over(boxes, cls)) & np.triu(np.ones(valid.shape[1:] * 2, bool), 1)
    keep = valid.copy()
    while True:
        new = valid & ~(keep[:, :, None] & o).any(1)
        if np.array_equal(new, keep):
            return keep
        keep = new


@pytest.mark.parametrize("k", [64, 65, 512, 1100])
def test_transcription_at_the_threshold(k):
    """Thresholds equal to IoUs the pairs really have (float32), and the
    float32 just below: iou > thr is false at the first, true at the
    second, for the very same pairs.  At K = 1,100 (the cluster greedy
    pass) the Pallas interpreter's IoU is XLA's CPU division, which is not
    correctly rounded (1 ulp off at ~3% of the pairs), and a pair 1 ulp
    from thr decides otherwise at 2 of the 8 thresholds: there the Pallas
    keep mask must be the greedy result over XLA's own IoU, and the
    transcription (IEEE division, as the card divides) equals
    suppress_sorted at every threshold."""
    rng = np.random.default_rng(k + 7)
    boxes, cls, valid = _inputs(rng, 2, k, 1)
    iou = _iou(boxes[0, :8], boxes[0, :8])
    values = iou[np.triu(np.ones((8, 8), bool), 1) & (iou > 0)]
    assert values.size
    for v in values[:4]:
        for thr in (float(v), float(np.nextafter(v, np.float32(0)))):
            got, pallas, plain = _all_three(boxes, cls, valid, thr)
            if k > 1024 and not np.array_equal(got, pallas):
                np.testing.assert_array_equal(pallas, _xla_greedy(boxes, cls, valid, thr))
            else:
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


def test_nms_trace_probes_fit_the_source():
    """``tools/nms_trace.py`` instruments csrc/nms.cu at fixed lines: each
    must be there once, so the tool keeps measuring this design."""
    from litepi_tpu_torch.tools import nms_trace

    src = nms_trace.instrumented_source()
    assert src.count("if (tr) {") == len(nms_trace.PROBES) + len(nms_trace.BEFORE) - 2
    assert "g_trace[" in src and "gtime()" in src
