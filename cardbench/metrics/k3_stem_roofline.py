"""K3's share of its roofline: the least time of one stem-kernel call
(``yardstick.stem_counts``: bytes over 3.35 TB/s or float32 operations
over 67 TFLOP/s, the larger) over its mean device time per call."""
from cardbench.metrics._common import roofline_pct


def read(run):
    return roofline_pct(run, "stem_counts", ("stem_tiled_kernel", "stem_generic_kernel"))
