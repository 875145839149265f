"""Device milliseconds per batch of the operations launched under the
program's ``litepi.vocab`` span: YOLO-World's contrastive class head at
vocabulary width, each level's BatchNorm and class conv, and the class
logits' flatten and float32 copy into one (B, A, nc) tensor
(``_spans.pair``, after ``_empty_memsets``); None where no operation lies
under it."""
from cardbench.metrics._empty_memsets import drop_empty_memsets
from cardbench.metrics._spans import pair

SPAN = "litepi.vocab"


def read(run):
    tail = pair(drop_empty_memsets(run))
    if tail is None:
        return None
    ns = [e - s for c, (_, s, e) in zip(tail.calls, tail.ops) if c.span == SPAN]
    return sum(ns) / 1e6 / len(tail.roots) if ns else None
