"""Wrapper of the ROI crop kernel (``csrc/roi.cu``).

Replaces the JAX package's Pallas kernel ``ops/pallas_roi.py::
pallas_crop_and_resize`` (pyramid mode) and its dense hat-matmul crop
``ops/roi.py::crop_and_resize`` (dense mode).  The plain version is
``ops/roi.py::crop_and_resize_plain``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from litepi_tpu_torch.kernels import LAUNCHES
from litepi_tpu_torch.kernels.build import check, load

MAX_LEVELS = 8  # csrc/roi.cu kMaxLevels
MAX_OUT = 512  # csrc/roi.cu kMaxOut (the block's tap tables in shared memory)


def _lib() -> ctypes.CDLL:
    lib = load("roi")
    fn = lib.litepi_roi_crop
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_float,
            ctypes.c_void_p,
            ctypes.c_int,
        ]
        fn.restype = ctypes.c_int
    return lib


def roi_crop_cuda(
    levels: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    valid: torch.Tensor,
    out_size: int,
    exact_extent: float,
    mode: str,
    round_bf16: bool = False,
) -> torch.Tensor:
    """(B, D, out, out, C) float32 crops of ``levels`` (level 0 the
    (B, H, W, C) uint8 frames; ``mode="dense"`` passes only it) at boxes
    (B, D, 4) float32 with valid (B, D) bool, all contiguous on one CUDA
    device.  ``round_bf16`` (either mode: a bf16 pipeline's crop) rounds
    the tap weights and y-lerps to bf16 values, as
    ``crop_and_resize_plain(..., round_bf16=True)`` does.  The launch is
    counted under ``roi_crop_<mode>``, the pyramid's bf16 mode under
    ``roi_crop_pyramid_bf16`` (a bf16 pipeline's ``roi_impl="pallas"``
    crop); the dense mode counts both roundings under one key."""
    if mode not in ("dense", "pyramid"):
        raise ValueError(f"unknown ROI crop mode {mode!r}")
    if mode == "dense" and len(levels) != 1:
        raise ValueError("dense mode takes the frames as its only level")
    if not 1 <= int(out_size) <= MAX_OUT:
        raise ValueError(f"out_size {out_size}; the kernel takes 1..{MAX_OUT}")
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} levels, got {len(levels)}")
    frames = levels[0]
    dev = frames.device
    b, c = int(frames.shape[0]), int(frames.shape[-1])
    for k, lvl in enumerate(levels):
        if lvl.dim() != 4 or lvl.shape[0] != b or lvl.shape[-1] != c:
            raise ValueError(f"level {k} must be (B, H, W, {c}), got {tuple(lvl.shape)}")
        if lvl.dtype != torch.uint8 or not lvl.is_cuda or lvl.device != dev:
            raise ValueError(f"level {k} must be uint8 on {dev}")
        if not lvl.is_contiguous():
            raise ValueError(f"level {k} must be contiguous")
    if boxes.dim() != 3 or boxes.shape[0] != b or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, D, 4), got {tuple(boxes.shape)}")
    d = int(boxes.shape[1])
    for name, t, dtype, shape in (
        ("boxes", boxes, torch.float32, (b, d, 4)),
        ("valid", valid, torch.bool, (b, d)),
    ):
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(
                f"{name} must be {shape} {dtype} on {dev}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty(
        (b, d, out_size, out_size, c), dtype=torch.float32, device=dev
    )
    if b == 0 or d == 0:
        return out
    n = len(levels)
    ptrs = (ctypes.c_void_p * n)(*[l.data_ptr() for l in levels])
    hs = (ctypes.c_int * n)(*[int(l.shape[1]) for l in levels])
    ws = (ctypes.c_int * n)(*[int(l.shape[2]) for l in levels])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = _lib().litepi_roi_crop(
            ptrs, hs, ws, n,
            boxes.data_ptr(), valid.data_ptr(), out.data_ptr(),
            b, d, c, int(out_size), float(exact_extent), stream, int(bool(round_bf16)),
        )
    check(status, f"roi_crop ({mode}) launch")
    bf16 = "_bf16" if round_bf16 and mode == "pyramid" else ""
    LAUNCHES[f"roi_crop_{mode}{bf16}"] += 1
    return out
