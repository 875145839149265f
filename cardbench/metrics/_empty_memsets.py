"""Memset calls that put nothing on the device, taken out before pairing.

cuDNN's engines for a convolution whose channel count is not a multiple
of 8 (YOLO12's 307-wide MLP convs) call ``cudaMemsetAsync`` on a workspace
of no bytes before their GEMM: 24 such calls per YOLO12-L batch, and no
device operation for any of them.  ``_spans.pair`` refuses a tail that
holds one (its calls and operations no longer pair one to one).

:func:`drop_empty_memsets` walks the tail's submission calls and device
operations from the end, as ``_spans.pair`` pairs them, and takes out of
the host events each memset call that meets an operation of another kind;
any other mismatch leaves the run as it is, for ``_spans.pair`` to refuse.
Where two memsets are launched back to back and only the first is empty,
the walk pairs the second call's operation with the first call instead: a
memset's time may then go to the span of its neighbour's call.
"""

from __future__ import annotations

from cardbench.metrics import _spans


def drop_empty_memsets(run: dict) -> dict:
    """``run`` with its empty memset calls taken out of ``host``."""
    if "window_ns" not in run:
        return run
    lo, hi = run["window_ns"]
    calls = _spans.submission_calls(run["host"], lo, hi)
    ops = sorted((d for d in run["device"] if lo <= d[1] < hi), key=lambda d: d[1])
    empty, j = set(), len(ops) - 1
    for s, e, kind in reversed(calls):
        if j >= 0 and _spans.op_kind(ops[j][0]) == kind:
            j -= 1
        elif kind == "memset":
            empty.add((s, e))
        else:
            return run
    if not empty:
        return run
    host = [h for h in run["host"]
            if not (_spans.submit_kind(h[0]) == "memset" and (h[1], h[2]) in empty)]
    return dict(run, host=host)
