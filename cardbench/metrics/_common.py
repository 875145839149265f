"""Arithmetic the per-layer readers share.  Each reader takes ``run``, what
the traced run collected (``cardbench/harness.py``):

``device``, ``host``
    (name, start ns, end ns) of the device's operations and the host's
    spans in the profiled tail; ``window_ns`` its (start, end);
``batches_traced``
    calls of the entry in that tail;
``frames_per_s``
    the rate in the untraced part;
``flops_per_frame``, ``stem_counts``, ``roi_counts``
    counts from the configuration, the shapes and the kept outputs.

A reader returns None where its run holds nothing to read."""

from __future__ import annotations

from typing import Optional, Sequence

from cardbench import yardstick


def idle_pct(run: dict) -> Optional[float]:
    if "window_ns" not in run:
        return None
    lo, hi = run["window_ns"]
    return 100.0 * (1.0 - yardstick.union_ns(run["device"], lo, hi) / (hi - lo))


def kind_ms_per_batch(run: dict, kind: str) -> Optional[float]:
    if "window_ns" not in run or not run.get("batches_traced"):
        return None
    ns = yardstick.ns_by_kind(run["device"], *run["window_ns"]).get(kind)
    return None if ns is None else ns / 1e6 / run["batches_traced"]


def roofline_pct(run: dict, counts_key: str, kernels: Sequence[str]) -> Optional[float]:
    """Bound per call over the kernels' mean device time per call, in %."""
    counts = run.get(counts_key)
    if counts is None or "window_ns" not in run:
        return None
    mean_ns = yardstick.mean_ns_of(run["device"], kernels, *run["window_ns"])
    if mean_ns is None:
        return None
    return 100.0 * yardstick.bound_s(*counts) / (mean_ns / 1e9)
