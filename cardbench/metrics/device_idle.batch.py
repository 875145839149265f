"""Share of the profiled tail in which no kernel, copy or set ran on the
card."""
from cardbench.metrics._common import idle_pct


def read(run):
    return idle_pct(run)
