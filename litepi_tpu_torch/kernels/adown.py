"""Wrapper of YOLOv9's ADown front end (``csrc/adown.cu``).

A port-only kernel: ADown has no counterpart in the JAX package.  From an
``ADown``'s input ``x`` it makes the inputs of its two convs in one pass:
the first half of the 2x2 stride-1 average pool's channels, and the 3x3/2
max pool of the second half, each written dense.  The plain version is
:func:`adown_front_plain`, ATen's ``avg_pool2d`` -> ``chunk`` ->
``max_pool2d`` chain, which the kernel matches bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from litepi_tpu_torch.kernels import LAUNCHES
from litepi_tpu_torch.kernels.build import check, load

C_STEP = 16  # the kernel's C is a multiple of this: each half a multiple of 8


def _lib() -> ctypes.CDLL:
    lib = load("adown")
    fn = lib.litepi_adown_front_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def takes_adown_kernel(x: torch.Tensor) -> bool:
    """Whether an ``ADown``'s front end on ``x`` runs as the kernel: ``x`` a
    bf16 CUDA tensor and no gradient to record.  Whatever else the kernel
    needs of such an ``x`` (dense channels last, C a multiple of 16) is
    :func:`adown_front_cuda`'s to check, and it raises where ``x`` falls
    short: on the card in bf16 there is no way back to the plain chain."""
    return (x.is_cuda and x.dtype == torch.bfloat16
            and not (torch.is_grad_enabled() and x.requires_grad))


def adown_front_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x1, x2p): ``avg_pool2d(x, 2, 1)`` split in two along channels,
    ``x1`` its first half and ``x2p`` the ``max_pool2d(·, 3, 2, 1)`` of its
    second (``x1`` a view, not dense)."""
    x1, x2 = F.avg_pool2d(x, 2, 1, 0, False, True).chunk(2, dim=1)
    return x1, F.max_pool2d(x2, 3, 2, 1)


def adown_front_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`adown_front_plain` as one kernel launch, bit for bit: ``x``
    (B, C, H, W) bf16 dense channels last on the card, C a multiple of 16,
    H and W at least 2; ``x1`` (B, C/2, H-1, W-1) and ``x2p`` (B, C/2,
    (H-2)//2 + 1, (W-2)//2 + 1) bf16 dense channels last.  Raises on
    anything the kernel does not take."""
    if not x.is_cuda or x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous(
            memory_format=torch.channels_last):
        raise ValueError(f"x must be a dense channels-last 4-D bf16 CUDA tensor, got "
                         f"{x.dim()}-D {x.dtype} on {x.device} with strides {x.stride()}")
    b, c, h, w = x.shape
    if c % C_STEP or c == 0:
        raise ValueError(f"x has {c} channels; the kernel takes a multiple of {C_STEP}")
    if h < 2 or w < 2:
        raise ValueError(f"x is {h}x{w}; the kernel takes at least 2x2")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")
    x1 = torch.empty((b, c // 2, h - 1, w - 1), dtype=x.dtype, device=x.device,
                     memory_format=torch.channels_last)
    x2p = torch.empty((b, c // 2, (h - 2) // 2 + 1, (w - 2) // 2 + 1), dtype=x.dtype,
                      device=x.device, memory_format=torch.channels_last)
    if b == 0:
        return x1, x2p
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.litepi_adown_front_bf16(x.data_ptr(), x1.data_ptr(), x2p.data_ptr(), b, h,
                                             w, c, stream)
    check(status, "adown_front launch")
    LAUNCHES["adown"] += 1
    return x1, x2p
