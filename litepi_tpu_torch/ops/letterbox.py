"""Letterbox resize: aspect-preserving resize + grey padding to a square.

Geometry follows the reference's cv2 letterbox: ``r = min(new/h, new/w)``,
padding 114 split as ``round(d - 0.1)`` top/left and ``round(d + 0.1)``
bottom/right (Python ``round``, half to even).  The resize is half-pixel
bilinear without antialiasing, source coordinates clamped to
``[0, limit - 1]``: ``F.interpolate(mode="bilinear", align_corners=False,
antialias=False)`` computes that map in float32.  In bfloat16 the resize
rounds where the JAX package's does: the tap weights and the rows of the
y-stage go to bf16 (:func:`_resize_bf16`).

:func:`letterbox_host` is the reference's host letterbox (``cv2.resize``
with ``INTER_LINEAR`` + a constant border), with cv2 imported when called.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from litepi_tpu_torch.ops.roi import axis_taps

PAD_VALUE = 114


def letterbox_params(
    h: int, w: int, new_shape: int = 640
) -> Tuple[float, float, float, Tuple[int, int], Tuple[int, int, int, int]]:
    """Returns ``(ratio, dw, dh, (new_w, new_h), (top, bottom, left,
    right))``; dw/dh are the half-padding before the rounding split."""
    r = min(new_shape / h, new_shape / w)
    new_w, new_h = int(round(w * r)), int(round(h * r))
    dw = (new_shape - new_w) / 2
    dh = (new_shape - new_h) / 2
    top = int(round(dh - 0.1))
    bottom = int(round(dh + 0.1))
    left = int(round(dw - 0.1))
    right = int(round(dw + 0.1))
    return r, dw, dh, (new_w, new_h), (top, bottom, left, right)


def letterbox_nchw(
    images: torch.Tensor, new_shape: int = 640, dtype=torch.float32
) -> torch.Tensor:
    """(B, H, W, 3) uint8 frames -> (B, 3, new, new) canvas in ``dtype``,
    values in [0, 255].  The resize runs in float32 (in bfloat16 with the
    JAX package's bf16 letterbox's roundings) and is cast once, as it is
    written into the canvas's image region."""
    b, h, w = images.shape[0], images.shape[1], images.shape[2]
    _, _, _, (new_w, new_h), (top, _, left, _) = letterbox_params(h, w, new_shape)
    x = images.permute(0, 3, 1, 2)
    if (w, h) == (new_shape, new_shape):
        # identity size: no resample, no pad band; the cast is the whole op
        return x.to(dtype)
    canvas = torch.full(
        (b, x.shape[1], new_shape, new_shape),
        float(PAD_VALUE),
        dtype=dtype,
        device=images.device,
    )
    region = canvas[:, :, top : top + new_h, left : left + new_w]
    if (new_w, new_h) == (w, h):
        region.copy_(x)
    elif dtype == torch.bfloat16:
        _resize_bf16(x, region)
    else:
        region.copy_(
            F.interpolate(
                x.float(),
                size=(new_h, new_w),
                mode="bilinear",
                align_corners=False,
                antialias=False,
            )
        )
    return canvas


@functools.lru_cache(maxsize=32)
def _resize_taps(src: int, dst: int, device: torch.device):
    """:func:`~litepi_tpu_torch.ops.roi.axis_taps` of a whole axis (start 0,
    extent and limit ``src``, ``dst`` samples): both taps' indices in one
    (2 * dst,) tensor, then each tap's weights rounded to bf16 values; made
    on ``device`` from fill kernels, so that no call copies from the host
    (and synchronises), and kept per size."""
    full = torch.full((1, 1), float(src), device=device)
    i0, i1, w0, w1 = axis_taps(torch.zeros_like(full), full, full, dst)
    return torch.cat([i0[0, 0], i1[0, 0]]), w0[0, 0].bfloat16().float(), w1[0, 0].bfloat16().float()


def _resize_bf16(x: torch.Tensor, out: torch.Tensor) -> None:
    """(B, C, H, W) uint8 -> ``out`` (B, C, h, w) bfloat16, rounded as the
    JAX package's bf16 letterbox rounds: hat weights in bf16, a y-stage
    whose float32 two-tap sums go to bf16, an x-stage summed in float32 and
    cast once as it is written.  Every product is exact in float32 (8
    significant bits by 8), so each stage's sum rounds once, as the JAX
    contraction's does.  One gather takes the uint8 pixels at both row taps
    and both column taps, so the y-stage runs only at the columns the
    x-stage reads; each stage's sum is written straight into its bf16
    tensor."""
    out_h, out_w = int(out.shape[2]), int(out.shape[3])
    rows, wy0, wy1 = _resize_taps(int(x.shape[2]), out_h, x.device)
    cols, wx0, wx1 = _resize_taps(int(x.shape[3]), out_w, x.device)
    p = x[:, :, rows[:, None], cols]  # (B, C, 2 * out_h, 2 * out_w) uint8
    y = torch.empty(p.shape[:2] + (out_h, 2 * out_w), dtype=torch.bfloat16, device=x.device)
    torch.addcmul(wy0[:, None] * p[:, :, :out_h], wy1[:, None], p[:, :, out_h:], out=y)
    torch.addcmul(wx0 * y[..., :out_w], wx1, y[..., out_w:], out=out)


def letterbox_device(
    images: torch.Tensor, new_shape: int = 640, dtype=torch.float32
) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, new, new, 3) in ``dtype``, values in
    [0, 255]: the JAX package's NHWC layout (a view of the NCHW canvas)."""
    return letterbox_nchw(images, new_shape, dtype).permute(0, 2, 3, 1)


def letterbox_host(
    image: np.ndarray, new_shape: int = 640
) -> Tuple[np.ndarray, float, Tuple[float, float]]:
    """The reference's host letterbox: ``image`` HWC uint8 in any colour
    order -> (canvas (new, new, C) uint8, ratio, (dw, dh)): ``cv2.resize``
    (``INTER_LINEAR``) to the letterbox size, then a constant 114 border
    split top/bottom/left/right as :func:`letterbox_params` gives it."""
    import cv2

    h, w = image.shape[:2]
    r, dw, dh, (new_w, new_h), (top, bottom, left, right) = letterbox_params(
        h, w, new_shape
    )
    if (new_w, new_h) != (w, h):
        image = cv2.resize(image, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    image = cv2.copyMakeBorder(
        image, top, bottom, left, right, cv2.BORDER_CONSTANT,
        value=(PAD_VALUE, PAD_VALUE, PAD_VALUE),
    )
    return image, r, (dw, dh)
