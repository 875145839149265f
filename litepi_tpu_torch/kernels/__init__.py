"""Hand-written CUDA kernels of the port and their launch counts.

Each wrapper adds one to its entry in :data:`LAUNCHES` where it launches
its kernel, and nowhere else, so a run can show which kernels its path
went through.  The wrappers live in ``kernels/nms.py``, ``kernels/roi.py``,
``kernels/stem.py`` and ``kernels/act.py``; the sources in ``csrc/``.
"""

from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {
    "nms_suppress": 0,
    "roi_crop_dense": 0,
    "roi_crop_pyramid": 0,
    "roi_crop_pyramid_bf16": 0,
    "stem": 0,
    "silu_bf16": 0,
    "sigmoid_bf16": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)
