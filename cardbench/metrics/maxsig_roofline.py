"""The max-sigmoid cores' share of their roofline: their least time per
batch (``cardbench/maxsig_counts.py`` on the ``yoloworldv2l-shufflenetv2``
configuration's file) over the device time per batch of every operation
launched under the program's ``litepi.maxsig`` span, whatever computes
the core (``_spans.pair``, after ``_empty_memsets``); None where no
operation lies under it."""
from cardbench import maxsig_counts
from cardbench.metrics._empty_memsets import drop_empty_memsets
from cardbench.metrics._spans import pair

CONFIG = "yoloworldv2l-shufflenetv2"
SPAN = "litepi.maxsig"


def read(run):
    tail = pair(drop_empty_memsets(run))
    if tail is None:
        return None
    ns = sum(e - s for c, (_, s, e) in zip(tail.calls, tail.ops) if c.span == SPAN)
    if not ns:
        return None
    return 100.0 * maxsig_counts.bound_s(CONFIG, run["batch"]) / (ns / 1e9 / len(tail.roots))
