"""Wrapper of the stem kernel (``csrc/stem.cu``).

Replaces the JAX package's Pallas kernel ``ops/pallas_stem.py::
pallas_stem``.  The plain version is ``ops/stem.py::stem_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from litepi_tpu_torch.kernels import LAUNCHES
from litepi_tpu_torch.kernels.build import check, load

MAX_CHANNELS = 256  # csrc/stem.cu kMaxChannels (weights in shared memory)
OUT_DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = load("stem")
    fn = lib.litepi_stem
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def stem_cuda(
    frames: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """(B, C, H/2, W/2) NCHW stem activations in ``out_dtype`` (float32 or
    bfloat16) from frames (B, H, W, 3) uint8 with H and W even, weight
    (27, C) float32 (HWIO taps in (dy, dx, ci) order) and bias (C,)
    float32, all contiguous on one CUDA device."""
    if frames.dim() != 4 or frames.shape[-1] != 3 or frames.dtype != torch.uint8:
        raise ValueError(
            f"frames must be (B, H, W, 3) uint8, got {tuple(frames.shape)} {frames.dtype}"
        )
    b, h, w = (int(s) for s in frames.shape[:3])
    if h % 2 or w % 2:
        raise ValueError(f"frame height and width must be even, got {h}x{w}")
    if weight.dim() != 2 or weight.shape[0] != 27:
        raise ValueError(f"weight must be (27, C), got {tuple(weight.shape)}")
    c = int(weight.shape[1])
    if not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"C={c} output channels; the kernel takes 1..{MAX_CHANNELS}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    dev = frames.device
    args = (("frames", frames), ("weight", weight), ("bias", bias))
    for (name, t), dtype, shape in zip(
        args, (torch.uint8, torch.float32, torch.float32), ((b, h, w, 3), (27, c), (c,))
    ):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}"
            )
    for name, t in args:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be on one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((b, c, h // 2, w // 2), dtype=out_dtype, device=dev)
    if b == 0 or h == 0 or w == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = _lib().litepi_stem(
            frames.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, h, w, c, int(out_dtype == torch.bfloat16), stream,
        )
    check(status, "stem launch")
    LAUNCHES["stem"] += 1
    return out
