"""Letterbox resize: aspect-preserving resize + grey padding to a square.

Geometry follows the reference's cv2 letterbox: ``r = min(new/h, new/w)``,
padding 114 split as ``round(d - 0.1)`` top/left and ``round(d + 0.1)``
bottom/right (Python ``round``, half to even).  The resize is half-pixel
bilinear without antialiasing, source coordinates clamped to
``[0, limit - 1]``: ``F.interpolate(mode="bilinear", align_corners=False,
antialias=False)`` computes that map.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

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
    values in [0, 255].  The resize runs in float32 and is cast once."""
    b, h, w = images.shape[0], images.shape[1], images.shape[2]
    _, _, _, (new_w, new_h), (top, _, left, _) = letterbox_params(h, w, new_shape)
    x = images.permute(0, 3, 1, 2)
    if (w, h) == (new_shape, new_shape):
        # identity size: no resample, no pad band; the cast is the whole op
        return x.to(dtype)
    if (new_w, new_h) == (w, h):
        resized = x.to(dtype)
    else:
        resized = F.interpolate(
            x.float(),
            size=(new_h, new_w),
            mode="bilinear",
            align_corners=False,
            antialias=False,
        ).to(dtype)
    canvas = torch.full(
        (b, x.shape[1], new_shape, new_shape),
        float(PAD_VALUE),
        dtype=dtype,
        device=images.device,
    )
    canvas[:, :, top : top + new_h, left : left + new_w] = resized
    return canvas


def letterbox_device(
    images: torch.Tensor, new_shape: int = 640, dtype=torch.float32
) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, new, new, 3) in ``dtype``, values in
    [0, 255]: the JAX package's NHWC layout (a view of the NCHW canvas)."""
    return letterbox_nchw(images, new_shape, dtype).permute(0, 2, 3, 1)
