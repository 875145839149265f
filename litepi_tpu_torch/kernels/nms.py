"""Wrapper of the NMS suppression kernel (``csrc/nms.cu``).

Replaces the JAX package's Pallas kernel ``ops/pallas_nms.py::
pallas_suppress``.  The plain version is ``ops/nms.py::suppress_sorted``.
"""

from __future__ import annotations

import ctypes

import torch

from litepi_tpu_torch.kernels import LAUNCHES
from litepi_tpu_torch.kernels.build import check, load


def _lib() -> ctypes.CDLL:
    lib = load("nms")
    fn = lib.litepi_nms_suppress
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_float,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        size = lib.litepi_nms_scratch_bytes
        size.argtypes = [ctypes.c_int, ctypes.c_int]
        size.restype = ctypes.c_size_t
    return lib


def nms_suppress_cuda(
    boxes: torch.Tensor,
    cls: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
) -> torch.Tensor:
    """Greedy per-class keep mask (B, K) bool over score-descending
    candidates: boxes (B, K, 4) float32 xyxy, cls (B, K) int32, valid (B, K)
    bool, all contiguous on one CUDA device; any K.

    Above K = 64 the kernel takes a scratch buffer for its suppression
    words (B * W * (64 W + 1) * 8 bytes, W = ceil(K / 64): 8.9 MB per image
    at K = 8,400), allocated here from PyTorch's caching allocator on the
    same stream (no synchronisation)."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    b, k = boxes.shape[0], boxes.shape[1]
    for name, t, dtype, shape in (
        ("boxes", boxes, torch.float32, (b, k, 4)),
        ("cls", cls, torch.int32, (b, k)),
        ("valid", valid, torch.bool, (b, k)),
    ):
        if not t.is_cuda or t.device != boxes.device:
            raise ValueError(f"{name} must be on {boxes.device}, got {t.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    lib = _lib()
    n_scratch = lib.litepi_nms_scratch_bytes(b, k)
    scratch = (
        torch.empty(n_scratch, dtype=torch.uint8, device=boxes.device)
        if n_scratch
        else None
    )
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.litepi_nms_suppress(
            boxes.data_ptr(),
            cls.data_ptr(),
            valid.data_ptr(),
            keep.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            b,
            k,
            float(iou_threshold),
            stream,
        )
    check(status, "nms_suppress launch")
    LAUNCHES["nms_suppress"] += 1
    return keep
