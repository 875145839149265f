"""Submission calls (kernel launches, asynchronous copies and sets) per
batch inside the program's ``litepi.run_fused`` span (``_spans.pair``)."""
from cardbench.metrics._spans import in_root, pair


def read(run):
    tail = pair(run)
    if tail is None:
        return None
    return sum(len(calls) for calls in in_root(tail)) / len(tail.roots)
