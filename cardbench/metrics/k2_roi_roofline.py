"""K2's share of its roofline: the least time of one dense ROI-crop call
on the kept outputs' boxes (``yardstick.roi_counts``) over its mean
device time per call."""
from cardbench.metrics._common import roofline_pct


def read(run):
    return roofline_pct(run, "roi_counts", ("roi_crop_kernel",))
