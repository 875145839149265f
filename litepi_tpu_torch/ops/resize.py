"""``jax.image.resize(x, shape, "bilinear")`` on NHWC tensors.

The JAX package's Faster R-CNN and SSD300 harnesses resize their frames
with ``jax.image.resize`` (``litepi_tpu/bench/detector_bench.py``), whose
default ``antialias=True`` filters when it downscales: each output sample
``o`` of an axis of ``n_in -> n_out`` lines weighs input line ``i`` by the
triangle ``max(0, 1 - |s_o - i| / k)`` with ``s_o = (o + 0.5) * n_in /
n_out - 0.5`` and ``k = max(n_in / n_out, 1)``, normalised over ``i``
(``jax._src.image.scale.compute_weight_mat``).  So a 2048 -> 640 or 640 ->
300 resize is *not* ``F.interpolate(antialias=False)``, which is the
letterbox's map.  An axis whose size does not change is left alone, as JAX
skips it.

The per-axis weight matrices are built once per size pair in float64
numpy, cast to float32, and applied as two products (``torch.matmul``:
a plain product outside any kernel, as JAX leaves it to XLA).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of one axis, antialiased when
    downscaling, as ``jax.image.resize``'s triangle kernel."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[:, None] - np.arange(n_in, dtype=np.float64)[None, :]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[:, None], w, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _device_weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """:func:`resize_weights` on ``device``, copied there once per size
    pair (a later call copies nothing from the host, so it does not
    synchronise)."""
    return torch.from_numpy(resize_weights(n_in, n_out)).to(device)


def resize_bilinear(images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, height, width, C) float32, as
    ``jax.image.resize(images.astype(float32), (B, height, width, C),
    "bilinear")``."""
    x = images.float()
    if x.shape[1] != height:
        wy = _device_weights(int(x.shape[1]), height, x.device)
        x = torch.einsum("oh,bhwc->bowc", wy, x)
    if x.shape[2] != width:
        wx = _device_weights(int(x.shape[2]), width, x.device)
        x = torch.einsum("pw,bowc->bopc", wx, x)
    return x
