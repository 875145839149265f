"""Device milliseconds per batch of the operations launched under the
program's ``litepi.c2fattn`` and ``litepi.maxsig`` spans: YOLO-World's
text-guided C2fAttn blocks whole, their convs, bottlenecks, concatenation
and max-sigmoid cores (``_spans.pair``, after ``_empty_memsets``); None
where no operation lies under them."""
from cardbench.metrics._empty_memsets import drop_empty_memsets
from cardbench.metrics._spans import pair

SPANS = ("litepi.c2fattn", "litepi.maxsig")


def read(run):
    tail = pair(drop_empty_memsets(run))
    if tail is None:
        return None
    ns = [e - s for c, (_, s, e) in zip(tail.calls, tail.ops) if c.span in SPANS]
    return sum(ns) / 1e6 / len(tail.roots) if ns else None
