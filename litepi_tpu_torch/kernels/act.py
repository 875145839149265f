"""Wrapper of the bf16 SiLU / sigmoid kernel (``csrc/act.cu``).

A port-only kernel: it replaces no TPU kernel, but five torch passes that
round each step of SiLU (or the four of sigmoid) to bf16 as the JAX
program does.  The plain versions are ``ops/act.py::silu_bf16_plain`` and
``sigmoid_bf16_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from litepi_tpu_torch.kernels import LAUNCHES
from litepi_tpu_torch.kernels.build import check, load


def _lib() -> ctypes.CDLL:
    lib = load("act")
    fn = lib.litepi_act_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def act_bf16_cuda(x: torch.Tensor, silu: bool) -> torch.Tensor:
    """``silu(x)`` (``silu=True``) or ``sigmoid(x)`` of a bf16 CUDA tensor,
    each step rounded to bf16; the result has ``x``'s shape and layout
    (a tensor that is neither contiguous nor channels-last contiguous is
    made contiguous first)."""
    if not x.is_cuda or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be a bf16 CUDA tensor, got {x.dtype} on {x.device}")
    if not (x.is_contiguous() or (x.dim() == 4 and x.is_contiguous(
            memory_format=torch.channels_last))):
        x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.litepi_act_bf16(x.data_ptr(), y.data_ptr(), x.numel(), int(silu), stream)
    check(status, "act_bf16 launch")
    LAUNCHES["silu_bf16" if silu else "sigmoid_bf16"] += 1
    return y
