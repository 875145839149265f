"""Device milliseconds per batch of the operations launched under the
program's ``litepi.candidates``, ``litepi.suppress``, ``litepi.unmap`` and
``litepi.crop`` spans: DFL decode and top-K, K1 and the crop budget's
slice, unmapping, K2 (``_spans.pair``)."""
from cardbench.metrics._spans import stage_ms


def read(run):
    return stage_ms(run, ("candidates", "suppress", "unmap", "crop"))
