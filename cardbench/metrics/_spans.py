"""Stage attribution from the program's own spans.

While a profiler runs, the program marks each call of its entry with a
``litepi.run_fused`` span holding one ``litepi.<stage>`` span per stage
(``litepi_tpu_torch/core/metrics.py::span``).  Those spans, CUDA's
submission calls and the device's operations all come from the one
profiler session of the traced tail, on one clock.

:func:`pair` pairs each device operation of the tail with the host call
that submitted it, and puts it down to the innermost ``litepi.*`` span (or
``cardbench.readback``) that holds the call.  The submission calls inside
the window and the device operations that start inside it, each in start
order (one stream), are paired from the end: the batches launched before
the tail began run at its start and have no calls in it.  The pairing is
refused (None) unless copies pair with copies, sets with sets and kernels
with launches, and every batch (from one ``litepi.run_fused`` to the next)
makes the same calls, its operations carrying the same names in the same
order.  A reader then reports nothing rather than a wrong number.  Times
are not compared across the two sides: the device's timestamps are
converted to the host's clock to within microseconds, so an operation
launched onto an idle card can read as starting before its call.
"""

from __future__ import annotations

import re
from bisect import bisect_left
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

ROOT = "litepi.run_fused"
PREFIX = "litepi."
READBACK = "cardbench.readback"
# the host calls that put work on a stream, by the kind of device
# operation each makes
SUBMIT = {"cudaLaunchKernel": "kernel", "cuLaunchKernel": "kernel",
          "cuLaunchKernelEx": "kernel", "cudaLaunchKernelExC": "kernel",
          "cudaMemcpyAsync": "memcpy", "cudaMemsetAsync": "memset"}
# CUPTI's API-version and per-thread-stream suffixes
_SUFFIX = re.compile(r"(_v\d+|_ptsz|_ptds)+$")

Interval = Tuple[str, int, int]  # (name, start ns, end ns)


class Call(NamedTuple):
    start: int
    end: int
    kind: str
    batch: int  # index of its litepi.run_fused span, -1 before the first
    span: Optional[str]  # innermost litepi.* or cardbench.readback span


class Tail(NamedTuple):
    roots: List[Tuple[int, int]]  # each litepi.run_fused span, in order
    calls: List[Call]
    ops: List[Interval]  # ops[i] was submitted by calls[i]


def submit_kind(name: str) -> Optional[str]:
    return SUBMIT.get(_SUFFIX.sub("", name))


def op_kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def submission_calls(host: Sequence[Interval], lo: int, hi: int) -> List[Tuple[int, int, str]]:
    """(start, end, kind) of the submission calls inside [lo, hi], in start
    order."""
    return sorted((s, e, k) for n, s, e in host
                  if lo <= s and e <= hi and (k := submit_kind(n)) is not None)


def _innermost(spans: Sequence[Interval], s: int, e: int) -> Optional[str]:
    holding = [(se - ss, n) for n, ss, se in spans if ss <= s and e <= se]
    return min(holding)[1] if holding else None


def pair(run: dict) -> Optional[Tail]:
    """The tail's batches, their submission calls and the device operation
    each call made; None where the run holds no program spans or the
    pairing does not hold (see the module's docstring)."""
    if "window_ns" not in run or not run.get("batches_traced"):
        return None
    lo, hi = run["window_ns"]
    host = [h for h in run["host"] if lo <= h[1] and h[2] <= hi]
    spans = sorted((h for h in host if h[0].startswith(PREFIX) or h[0] == READBACK),
                   key=lambda h: h[1])
    roots = sorted((s, e) for n, s, e in spans if n == ROOT)
    if len(roots) != run["batches_traced"]:
        return None
    starts = [s for s, _ in roots]
    span_starts = [h[1] for h in spans]
    calls: List[Call] = []
    for s, e, kind in submission_calls(host, lo, hi):
        k = bisect_left(starts, s + 1) - 1  # the last root that starts at or before s
        span = None
        if k >= 0:
            # the spans of batch k: from its root's start to the next root's
            upto = starts[k + 1] if k + 1 < len(starts) else hi + 1
            own = spans[bisect_left(span_starts, starts[k]):bisect_left(span_starts, upto)]
            span = _innermost(own, s, e)
        calls.append(Call(s, e, kind, k, span))
    ops = sorted((d for d in run["device"] if lo <= d[1] < hi), key=lambda d: d[1])
    if not calls or len(ops) < len(calls):
        return None
    ops = ops[len(ops) - len(calls):]
    if any(op_kind(op[0]) != c.kind for c, op in zip(calls, ops)):
        return None
    per_batch: Dict[int, List[str]] = {}
    for c, op in zip(calls, ops):
        if c.batch >= 0:
            per_batch.setdefault(c.batch, []).append(op[0])
    if len(per_batch) != len(roots) or len({tuple(v) for v in per_batch.values()}) != 1:
        return None
    return Tail(roots, calls, ops)


def stage_ms(run: dict, stages: Sequence[str]) -> Optional[float]:
    """Device ms per batch of the operations launched under the spans
    ``litepi.<stage>`` for each of ``stages``."""
    tail = pair(run)
    if tail is None:
        return None
    names = {PREFIX + s for s in stages}
    ns = sum(e - s for c, (_, s, e) in zip(tail.calls, tail.ops) if c.span in names)
    return ns / 1e6 / len(tail.roots)


def in_root(tail: Tail) -> List[List[Call]]:
    """The submission calls inside each ``litepi.run_fused`` span."""
    out: List[List[Call]] = [[] for _ in tail.roots]
    for c in tail.calls:
        if c.batch >= 0:
            s, e = tail.roots[c.batch]
            if s <= c.start and c.end <= e:
                out[c.batch].append(c)
    return out
