"""The area-attention cores' share of their roofline: their least time per
batch (``cardbench/attn_counts.py`` on the ``yolo12l-shufflenetv2``
configuration's file) over the device time per batch of SDPA's flash
kernels launched under the program's ``litepi.attn`` span
(``_spans.pair``, after ``_empty_memsets``)."""
from cardbench import attn_counts
from cardbench.metrics._empty_memsets import drop_empty_memsets
from cardbench.metrics._spans import pair

CONFIG = "yolo12l-shufflenetv2"
SPAN = "litepi.attn"


def read(run):
    tail = pair(drop_empty_memsets(run))
    if tail is None:
        return None
    ns = sum(e - s for c, (name, s, e) in zip(tail.calls, tail.ops)
             if c.span == SPAN and "flash" in name.lower())
    if not ns:
        return None
    return 100.0 * attn_counts.bound_s(CONFIG, run["batch"]) / (ns / 1e9 / len(tail.roots))
