"""Wrapper of the bf16 SiLU / sigmoid kernel (``csrc/act.cu``).

A port-only kernel: it replaces no TPU kernel, but five torch passes that
round each step of SiLU (or the four of sigmoid) to bf16 as the JAX
program does, in its backward mode the passes of their gradient, in its
bias mode a biased conv's bias add with the SiLU after it, and in its
BatchNorm mode an eval BatchNorm with the SiLU (or nothing) after it.
The plain versions are ``ops/act.py::silu_bf16_plain``,
``sigmoid_bf16_plain``, ``silu_bf16_grad_plain``,
``sigmoid_bf16_grad_plain``, ``silu_bias_bf16_plain``,
``batch_norm_bf16_plain`` and ``batch_norm_silu_bf16_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from litepi_tpu_torch.kernels import LAUNCHES
from litepi_tpu_torch.kernels.build import check, load
from litepi_tpu_torch.ops.act import BN_ACT_MAX_CHANNELS


def _lib() -> ctypes.CDLL:
    lib = load("act")
    fn = lib.litepi_act_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        bwd = lib.litepi_act_bf16_backward
        bwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        biased = lib.litepi_silu_bias_bf16
        biased.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        biased.restype = ctypes.c_int
        bn = lib.litepi_bn_act_bf16
        bn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_double, ctypes.c_void_p] + [
            ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        bn.restype = ctypes.c_int
    return lib


def _dense(x: torch.Tensor) -> torch.Tensor:
    """``x`` if it is contiguous or channels-last contiguous, else a
    contiguous copy."""
    if x.is_contiguous() or (x.dim() == 4 and x.is_contiguous(
            memory_format=torch.channels_last)):
        return x
    return x.contiguous()


def act_bf16_cuda(x: torch.Tensor, silu: bool) -> torch.Tensor:
    """``silu(x)`` (``silu=True``) or ``sigmoid(x)`` of a bf16 CUDA tensor,
    each step rounded to bf16; the result has ``x``'s shape and layout
    (a tensor that is neither contiguous nor channels-last contiguous is
    made contiguous first)."""
    if not x.is_cuda or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be a bf16 CUDA tensor, got {x.dtype} on {x.device}")
    x = _dense(x)
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


def act_bias_bf16_cuda(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``silu(x + bias)`` of a bf16 CUDA tensor ``x`` (N, C, H, W) and a
    bf16 ``bias`` (C,) on its device, the bias added over the channel axis:
    the add rounded to bf16 as ATen's, then each SiLU step rounded to bf16.
    The result has ``x``'s shape and layout (an ``x`` that is neither
    contiguous nor channels-last contiguous is made contiguous first)."""
    if not x.is_cuda or x.dtype != torch.bfloat16 or x.dim() != 4:
        raise ValueError(f"x must be a 4-D bf16 CUDA tensor, got {x.dim()}-D {x.dtype} "
                         f"on {x.device}")
    if (bias.device != x.device or bias.dtype != torch.bfloat16
            or tuple(bias.shape) != (x.shape[1],) or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous bf16 ({x.shape[1]},) tensor on {x.device}, "
                         f"got {tuple(bias.shape)} {bias.dtype} on {bias.device}")
    x = _dense(x)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.litepi_silu_bias_bf16(
            x.data_ptr(), bias.data_ptr(), y.data_ptr(), x.numel(), x.shape[1],
            x.shape[2] * x.shape[3], int(not x.is_contiguous()), stream)
    check(status, "silu_bias_bf16 launch")
    LAUNCHES["silu_bias_bf16"] += 1
    return y


def bn_act_bf16_cuda(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                     weight: torch.Tensor, bias: torch.Tensor, eps: float,
                     silu: bool) -> torch.Tensor:
    """An eval BatchNorm of a bf16 CUDA tensor ``x`` (N, C, H, W) over its
    channel axis, then SiLU (``silu=True``) or nothing: ``bf16(weight * (x
    - mean) * invstd + bias)`` with ``invstd = rsqrt(var + eps)``, in
    float32 as ATen's eval BatchNorm computes it, then each SiLU step
    rounded to bf16.  ``mean``, ``var`` (the running statistics),
    ``weight`` and ``bias`` are contiguous float32 (C,) tensors on ``x``'s
    device, C at most ``BN_ACT_MAX_CHANNELS``; they are read on every
    call.  The result has ``x``'s shape and layout (an ``x`` that is
    neither contiguous nor channels-last contiguous is made contiguous
    first)."""
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise ValueError(f"x must be a 4-D bf16 CUDA tensor, got {x.dim()}-D {x.dtype} "
                         f"on {x.device}")
    c = x.shape[1]
    if c > BN_ACT_MAX_CHANNELS:
        raise ValueError(f"x has {c} channels, more than {BN_ACT_MAX_CHANNELS}")
    for name, t in (("mean", mean), ("var", var), ("weight", weight), ("bias", bias)):
        if (t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != (c,)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 ({c},) tensor on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if not x.is_cuda:
        raise ValueError(f"x must be a 4-D bf16 CUDA tensor, got one on {x.device}")
    x = _dense(x)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.litepi_bn_act_bf16(
            x.data_ptr(), mean.data_ptr(), var.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            float(eps), y.data_ptr(), x.numel(), c, x.shape[2] * x.shape[3],
            int(not x.is_contiguous()), int(silu), stream)
    check(status, "bn_act_bf16 launch")
    LAUNCHES["bn_silu_bf16" if silu else "bn_bf16"] += 1
    return y


def act_bf16_backward_cuda(x: torch.Tensor, g: torch.Tensor, silu: bool) -> torch.Tensor:
    """The gradient of :func:`act_bf16_cuda` at ``x`` for the output
    gradient ``g`` (bf16 CUDA tensors of one shape), each step rounded to
    bf16 as ``jax.vjp`` of the JAX program's ops; the result has ``x``'s
    layout (``g`` is copied to it where the two differ)."""
    for t in (x, g):
        if not t.is_cuda or t.dtype != torch.bfloat16:
            raise ValueError(f"x and g must be bf16 CUDA tensors, got {t.dtype} on {t.device}")
    if x.shape != g.shape:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} differ in shape")
    x = _dense(x)
    if g.stride() != x.stride():
        g = torch.empty_like(x).copy_(g)
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.litepi_act_bf16_backward(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), x.numel(), int(silu), stream)
    check(status, "act_bf16_backward launch")
    LAUNCHES["silu_bf16_bwd" if silu else "sigmoid_bf16_bwd"] += 1
    return dx
