"""The ADown front ends' share of their roofline: their least time per
batch (``cardbench/adown_counts.py`` on the ``yolov9e-shufflenetv2``
configuration's file: one pass's bf16 bytes over 3.35 TB/s) over the
device time per batch of every operation launched under the program's
``litepi.adown`` span, whatever computes the pools (``_spans.pair``, after
``_empty_memsets``); None where no operation lies under it."""
from cardbench import adown_counts
from cardbench.metrics._empty_memsets import drop_empty_memsets
from cardbench.metrics._spans import pair

CONFIG = "yolov9e-shufflenetv2"
SPAN = "litepi.adown"


def read(run):
    tail = pair(drop_empty_memsets(run))
    if tail is None:
        return None
    ns = sum(e - s for c, (_, s, e) in zip(tail.calls, tail.ops) if c.span == SPAN)
    if not ns:
        return None
    return 100.0 * adown_counts.bound_s(CONFIG, run["batch"]) / (ns / 1e9 / len(tail.roots))
