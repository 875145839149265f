"""ROI crop + resize: the bridge between detector and classifier.

Reference semantics: each box is integer-truncated (``floor``), width and
height at least 1, and resampled to ``out x out`` at half-pixel centres
with 2-tap bilinear weights ``max(0, 1 - |u - g|)``, sample coordinates
clamped to ``[0, limit - 1]``; invalid slots give zero crops.  Frames are
(B, H, W, C) uint8, crops (B, D, out, out, C) float32.

Two contracts, both computed by the ROI kernel (``csrc/roi.cu``) on a CUDA
tensor and by :func:`crop_and_resize_plain` on a CPU tensor:

* :func:`crop_and_resize` — the JAX package's dense crop, exact 2-tap
  bilinear on the frame at any box extent;
* :func:`crop_and_resize_pyramid` — the JAX ``pallas_crop_and_resize``
  contract: each ROI samples the smallest level of a 4^k average-pooled
  uint8 pyramid on which its extent is at most :data:`EXACT_EXTENT`.

The JAX package's ``roi_chunk`` loop knob has no meaning here (the kernel
covers every ROI in one launch); the crop always computes in float32.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

# extent bound of the JAX pyramid crop (its 128-row slab minus 10 rows of
# alignment slack); kept so pyramid mode picks the same levels
EXACT_EXTENT = 118


def pyramid_scales(h: int, w: int, exact_extent: int = EXACT_EXTENT) -> List[int]:
    """4^k level scales until the frame's longer side fits ``exact_extent``."""
    scales = [1]
    while max(h, w) // scales[-1] > exact_extent:
        scales.append(scales[-1] * 4)
    return scales


def build_pyramid(frames: torch.Tensor, n_levels: int) -> List[torch.Tensor]:
    """[frames, 4x4-average level 1, ...]: each level is the 4x4 mean of the
    one before (valid windows only), rounded half to even into uint8."""
    levels = [frames]
    for _ in range(1, n_levels):
        prev = levels[-1]
        b, h, w, c = prev.shape
        hk, wk = h // 4, w // 4
        if hk == 0 or wk == 0:
            raise ValueError(
                f"frame {tuple(frames.shape[1:3])} too small for "
                f"{n_levels} pyramid levels"
            )
        win = prev[:, : hk * 4, : wk * 4].reshape(b, hk, 4, wk, 4, c)
        mean = win.float().sum(dim=(2, 4)) * 0.0625
        levels.append(torch.round(mean).to(torch.uint8).contiguous())
    return levels


def axis_taps(start, extent, limit, out_size: int):
    """Per-ROI 2-tap sampling along one axis.

    start, extent, limit: (B, D) float32.  Returns (i0, i1, w0, w1), each
    (B, D, out): the two source lines and their hat weights.  ``i1`` is
    clamped into range; its weight is then 0.
    """
    o = torch.arange(out_size, dtype=torch.float32, device=start.device) + 0.5
    # true division by a tensor (a CUDA divide by a Python scalar would
    # multiply by its reciprocal and round differently)
    step = extent / torch.full_like(extent, float(out_size))
    u = o * step[..., None] - 0.5 + start[..., None]
    u = torch.minimum(torch.clamp(u, min=0.0), limit[..., None] - 1.0)
    g0 = torch.floor(u)
    g1 = g0 + 1.0
    w0 = torch.clamp(1.0 - torch.abs(u - g0), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs(u - g1), min=0.0)
    i1 = torch.minimum(g1, limit[..., None] - 1.0)
    return g0.long(), i1.long(), w0, w1


def roi_geometry(
    boxes: torch.Tensor,
    level_hw: Sequence[Tuple[int, int]],
    exact_extent: int,
):
    """Per-ROI level and sampling window, as the kernel computes them.

    Returns (lv, ys, ye, xs, xe, yl, xl), each (B, D): level index, start
    and extent per axis in level pixels, and the level's height/width.
    With one level every ROI samples the frame itself (dense mode).
    """
    x1 = torch.floor(boxes[..., 0])
    y1 = torch.floor(boxes[..., 1])
    bw = torch.clamp(torch.floor(boxes[..., 2]) - x1, min=1.0)
    bh = torch.clamp(torch.floor(boxes[..., 3]) - y1, min=1.0)
    n = len(level_hw)
    dev = boxes.device
    scales = torch.tensor([4.0 ** k for k in range(n)], device=dev)
    lv = torch.zeros(boxes.shape[:-1], dtype=torch.long, device=dev)
    ext = torch.maximum(bw, bh)
    for k in range(n - 1):
        lv += (ext > exact_extent * scales[k]).long()
    s = scales[lv]
    lim_h = torch.tensor([float(h) for h, _ in level_hw], device=dev)[lv]
    lim_w = torch.tensor([float(w) for _, w in level_hw], device=dev)[lv]
    return lv, y1 / s, bh / s, x1 / s, bw / s, lim_h, lim_w


def crop_and_resize_plain(
    levels: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    valid: torch.Tensor,
    out_size: int,
    exact_extent: int = EXACT_EXTENT,
) -> torch.Tensor:
    """Plain version of the ROI kernel, on any device.

    levels: [(B, H_k, W_k, C) uint8], level 0 the frames; one level is the
    dense crop.  The arithmetic is the kernel's, in the same order: lerp
    along y at the two source columns, then along x.
    """
    b, d = boxes.shape[0], boxes.shape[1]
    c = levels[0].shape[-1]
    level_hw = [(int(l.shape[1]), int(l.shape[2])) for l in levels]
    lv, ys, ye, xs, xe, yl, xl = roi_geometry(boxes, level_hw, exact_extent)
    y0, y1, wy0, wy1 = axis_taps(ys, ye, yl, out_size)
    x0, x1, wx0, wx1 = axis_taps(xs, xe, xl, out_size)

    # one flat buffer over every level; per ROI its level's offset/width
    flat = torch.cat([l.reshape(-1) for l in levels])
    sizes = [l.numel() for l in levels]
    dev = boxes.device
    offsets = torch.tensor([sum(sizes[:k]) for k in range(len(levels))], device=dev)
    per_img = torch.tensor([h * w * c for h, w in level_hw], device=dev)
    widths = torch.tensor([w for _, w in level_hw], device=dev)
    bidx = torch.arange(b, device=dev)[:, None]
    base = offsets[lv] + bidx * per_img[lv]  # (B, D)
    row_stride = (widths[lv] * c)[..., None]  # (B, D, 1)
    ch = torch.arange(c, device=dev)

    def tap(yi, xi):
        idx = (
            base[..., None, None, None]
            + (yi * row_stride)[..., :, None, None]
            + (xi * c)[..., None, :, None]
            + ch
        )
        return flat[idx.reshape(-1)].reshape(idx.shape).float()

    wy0, wy1 = wy0[..., :, None, None], wy1[..., :, None, None]
    wx0, wx1 = wx0[..., None, :, None], wx1[..., None, :, None]
    t0 = wy0 * tap(y0, x0) + wy1 * tap(y1, x0)
    t1 = wy0 * tap(y0, x1) + wy1 * tap(y1, x1)
    crops = wx0 * t0 + wx1 * t1
    return torch.where(valid[..., None, None, None], crops, 0.0).reshape(
        b, d, out_size, out_size, c
    )


def _check_frames(images: torch.Tensor) -> None:
    if images.dtype != torch.uint8 or images.dim() != 4:
        raise ValueError(
            f"frames must be (B, H, W, C) uint8, got {tuple(images.shape)} "
            f"{images.dtype}"
        )


def _crop(levels, boxes, valid, out_size, exact_extent, mode):
    if boxes.is_cuda:
        from litepi_tpu_torch.kernels.roi import roi_crop_cuda

        return roi_crop_cuda(levels, boxes, valid, out_size, exact_extent, mode)
    if boxes.device.type != "cpu":
        raise ValueError(f"no ROI crop for device {boxes.device}")
    return crop_and_resize_plain(levels, boxes, valid, out_size, exact_extent)


def crop_and_resize(
    images: torch.Tensor,
    boxes: torch.Tensor,
    valid: torch.Tensor,
    out_size: int = 64,
    chunk: int = 1,
) -> torch.Tensor:
    """Dense crop: exact 2-tap bilinear on the frame at any box extent.

    images (B, H, W, C) uint8; boxes (B, D, 4) xyxy float32 in frame
    pixels; valid (B, D) bool.  Returns (B, D, out, out, C) float32.
    ``chunk`` is the JAX package's TPU loop knob: accepted and ignored.
    """
    del chunk
    _check_frames(images)
    return _crop([images], boxes, valid, out_size, EXACT_EXTENT, "dense")


def crop_and_resize_pyramid(
    images: torch.Tensor,
    boxes: torch.Tensor,
    valid: torch.Tensor,
    out_size: int = 64,
) -> torch.Tensor:
    """Pyramid crop (the JAX ``pallas_crop_and_resize`` contract): a box
    whose extent exceeds :data:`EXACT_EXTENT` samples the 4^k average-pooled
    level that brings it under the bound (anti-aliased); smaller boxes
    match the dense crop.  Same shapes as :func:`crop_and_resize`."""
    _check_frames(images)
    h, w = int(images.shape[1]), int(images.shape[2])
    levels = build_pyramid(images, len(pyramid_scales(h, w)))
    return _crop(levels, boxes, valid, out_size, EXACT_EXTENT, "pyramid")
