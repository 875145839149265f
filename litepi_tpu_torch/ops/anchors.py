"""Static anchor-point / stride tables for the anchor-free detector head.

8,400 positions at 640 = 80^2 + 40^2 + 20^2 cells at strides 8/16/32, each
at its cell centre (+0.5), flattened row-major (y, x) per level, P3..P5.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def make_anchors(
    input_size: int = 640,
    strides: Sequence[int] = (8, 16, 32),
    cell_offset: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Build (anchor_points (A, 2) float32 (x, y) in feature-map units,
    stride_per_anchor (A, 1) float32)."""
    points, strides_out = [], []
    for s in strides:
        n = input_size // s
        xs = np.arange(n, dtype=np.float32) + cell_offset
        ys = np.arange(n, dtype=np.float32) + cell_offset
        gx, gy = np.meshgrid(xs, ys)
        points.append(np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1))
        strides_out.append(np.full((n * n, 1), float(s), dtype=np.float32))
    return (
        np.concatenate(points, axis=0),
        np.concatenate(strides_out, axis=0),
    )
