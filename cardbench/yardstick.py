"""The benchmark's yardstick: published peaks, the kernels' operation and
byte counts, the model FLOP count, and the reduction of a
profiler trace to busy time, time by kind, the top operations and the idle
gaps.  Pure functions of shapes, data and events, so that they run and are
tested on the CPU.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

# one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at 700 W
BF16_FLOPS = 989e12
F32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and float32 operations over the float32 peak, in seconds."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS)


def stem_counts(batch: int, h: int, w: int, c: int) -> Tuple[float, float]:
    """(bytes, operations) of one stem-kernel call (K3): uint8 frames (B, H,
    W, 3) read once, bf16 (B, H/2, W/2, C) written once, the folded 3x3x3
    weights and bias read once; per output 27 multiply-adds (2 operations
    each), the bias add and SiLU's add, divide and multiply."""
    n_out = batch * c * (h // 2) * (w // 2)
    return batch * h * w * 3 + 2 * n_out + 4 * 28 * c, n_out * (2 * 27 + 4)


def _axis_taps(start, extent, limit, out: int):
    o = torch.arange(out, dtype=torch.float32) + 0.5
    step = extent / torch.full_like(extent, float(out))
    u = o * step[..., None] - 0.5 + start[..., None]
    u = torch.minimum(torch.clamp(u, min=0.0), limit[..., None] - 1.0)
    g0 = torch.floor(u)
    return g0.long(), torch.minimum(g0 + 1.0, limit[..., None] - 1.0).long()


def roi_counts(boxes, valid, h: int, w: int, out: int, channels: int = 3) -> Tuple[float, float]:
    """(bytes, operations) of one dense ROI-crop call (K2) on these boxes
    (B, D, 4) frame pixels and ``valid`` (B, D): per valid ROI the distinct
    source rows times the distinct columns its taps touch, read once; the
    boxes and the mask read once; the float32 crops (B, D, out, out, C)
    written once; 9 operations per valid output value (two 2-tap lerps)."""
    boxes = torch.as_tensor(boxes, dtype=torch.float32)
    valid = torch.as_tensor(valid, dtype=torch.bool)
    x1, y1 = torch.floor(boxes[..., 0]), torch.floor(boxes[..., 1])
    bw = torch.clamp(torch.floor(boxes[..., 2]) - x1, min=1.0)
    bh = torch.clamp(torch.floor(boxes[..., 3]) - y1, min=1.0)

    def distinct(start, extent, limit):
        i0, i1 = _axis_taps(start, extent, torch.full_like(start, float(limit)), out)
        taps = torch.cat([i0, i1], -1).sort(-1).values
        return 1 + (taps[..., 1:] != taps[..., :-1]).sum(-1)

    rows, cols = distinct(y1, bh, h), distinct(x1, bw, w)
    touched = int((rows * cols * valid).sum()) * channels
    n_out = boxes.shape[0] * boxes.shape[1] * out * out * channels
    n_valid_out = int(valid.sum()) * out * out * channels
    return touched + boxes.numel() * 4 + valid.numel() + n_out * 4, 9 * n_valid_out


def model_flops(build, shape: Sequence[int]) -> int:
    """FLOPs of one forward pass of the model ``build()`` makes, on an input
    of ``shape``, counted by ``FlopCounterMode`` on the meta device (2 per
    multiply-add; convolutions and matrix products)."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        model = build()
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.zeros(shape, device="meta"))
    return counter.get_total_flops()


# device-time kinds by kernel name, first match wins
KINDS = (
    ("nms_kernel", ("nms_",)),
    ("roi_kernel", ("roi_crop_kernel",)),
    ("stem_kernel", ("stem_tiled_kernel", "stem_generic_kernel")),
    ("conv_gemm", ("conv", "cudnn", "xmma", "gemm", "sm90_", "implicit", "cutlass",
                   "wgrad", "dgrad", "fprop")),
    ("sort_topk", ("sort", "radix", "topk")),
    ("memcpy", ("memcpy",)),
    ("memset", ("memset",)),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


Interval = Tuple[str, int, int]  # (name, start_ns, end_ns)


def union_ns(intervals: Iterable[Interval], lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) covered by at least one interval."""
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in intervals if e > lo and s < hi)
    total, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(device: Sequence[Interval], host: Sequence[Interval], lo: int, hi: int,
              top: int = 10) -> List[List]:
    """The ``top`` longest stretches of [lo, hi) with no device activity,
    each named by the innermost host span open at its start (``idle``
    where none is): ``[[name, seconds], ...]``."""
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in device if e > lo and s < hi)
    gaps, cursor = [], lo
    for s, e in spans:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        gaps.append((cursor, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for g0, g1 in gaps[:top]:
        open_spans = [(e - s, n) for n, s, e in host if s <= g0 < e]
        name = min(open_spans)[1] if open_spans else "idle"
        out.append([name, (g1 - g0) / 1e9])
    return out


def top_ops(device: Sequence[Interval], lo: int, hi: int, top: int = 10) -> List[List]:
    """Device operations by total time inside [lo, hi): ``[[name, seconds]]``."""
    totals: Dict[str, int] = {}
    for n, s, e in device:
        d = min(e, hi) - max(s, lo)
        if d > 0:
            totals[n] = totals.get(n, 0) + d
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return [[n[:120], t / 1e9] for n, t in ranked]


def ns_by_kind(device: Sequence[Interval], lo: int, hi: int) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for n, s, e in device:
        d = min(e, hi) - max(s, lo)
        if d > 0:
            k = kind_of(n)
            out[k] = out.get(k, 0) + d
    return out


def mean_ns_of(device: Sequence[Interval], keys: Sequence[str], lo: int, hi: int) -> Optional[float]:
    """Mean duration of the device operations whose name holds one of
    ``keys`` and that started inside [lo, hi); None where there is none."""
    durs = [e - s for n, s, e in device if lo <= s < hi and any(k in n for k in keys)]
    return sum(durs) / len(durs) if durs else None


def finite(x: Optional[float]) -> Optional[float]:
    return x if x is not None and math.isfinite(x) else None
