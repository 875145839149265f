"""Device milliseconds per batch of the operations launched under the
program's ``litepi.elan`` span: YOLOv9's GELAN blocks (``RepNCSPELAN4``)
whole, their convs, RepCSPs, residual adds and concatenations
(``_spans.pair``, after ``_empty_memsets``); None where no operation lies
under it."""
from cardbench.metrics._empty_memsets import drop_empty_memsets
from cardbench.metrics._spans import pair

SPAN = "litepi.elan"


def read(run):
    tail = pair(drop_empty_memsets(run))
    if tail is None:
        return None
    ns = [e - s for c, (_, s, e) in zip(tail.calls, tail.ops) if c.span == SPAN]
    return sum(ns) / 1e6 / len(tail.roots) if ns else None
