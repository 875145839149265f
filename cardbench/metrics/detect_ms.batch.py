"""Device milliseconds per batch of the operations launched under the
program's ``litepi.stem`` and ``litepi.detect`` spans: the detector, its
stem (K3 or the letterbox) and body (``_spans.pair``)."""
from cardbench.metrics._spans import stage_ms


def read(run):
    return stage_ms(run, ("stem", "detect"))
