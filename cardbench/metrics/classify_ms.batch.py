"""Device milliseconds per batch of the operations launched under the
program's ``litepi.classify`` span: the global crop budget, the classifier
and the outputs' argmax / amax (``_spans.pair``)."""
from cardbench.metrics._spans import stage_ms


def read(run):
    return stage_ms(run, ("classify",))
