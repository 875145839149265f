"""Host milliseconds per batch inside the program's ``litepi.run_fused``
span, less the time inside the submission calls it holds (which block
while CUDA's launch queue is full): the host's own cost of issuing a
batch, Python and ATen dispatch (``_spans.pair``)."""
from cardbench.metrics._spans import in_root, pair


def read(run):
    tail = pair(run)
    if tail is None:
        return None
    ns = sum((e - s) - sum(c.end - c.start for c in calls)
             for (s, e), calls in zip(tail.roots, in_root(tail)))
    return ns / 1e6 / len(tail.roots)
