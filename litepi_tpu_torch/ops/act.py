"""SiLU and sigmoid as the JAX program rounds them.

JAX writes flax's bf16 SiLU into its StableHLO as five bf16 ops (negate,
exponential, add 1, divide 1 by it, multiply by x) and ``jax.nn.sigmoid``
as the first four, so the JAX program rounds after each step on every
backend; torch's ``F.silu`` and ``torch.sigmoid`` round once (39.4% and
28.4% of bf16 SiLU values differ from JAX's on N(0, 3^2) inputs).  In bf16,
:func:`silu` and :func:`sigmoid` round at each step: the kernel
``csrc/act.cu`` on a CUDA tensor (one pass), the plain versions on a CPU
tensor.  Float32 stays on ``F.silu`` and ``torch.sigmoid``.

Their gradient in bf16 is what ``jax.vjp`` of the same ops computes, each
op rounded: with ``s`` the bf16 sigmoid and ``d = s * (1 - s)`` (JAX's
derivative of ``logistic``), SiLU's ``g * s + (x * g) * d`` and sigmoid's
``g * d``.  A ``torch.autograd.Function`` carries it: its backward is the
act kernel's backward mode on a CUDA tensor, the plain passes on a CPU
tensor.  Without autograd (no grad needed) the forward runs alone, as
before.

``silu(x, bias)`` is SiLU of a biased conv's output taken without its
bias: the bias add rounded to bf16 as ATen's (and flax's), then the five
steps.  In bf16 without autograd it is the act kernel's bias mode on a
CUDA tensor, one pass in place of the add's and the SiLU's, and
:func:`silu_bias_bf16_plain` on a CPU tensor; otherwise the add, then
:func:`silu`.

:func:`batch_norm_act` is an eval BatchNorm of a bf16 tensor with float32
statistics and parameters as ATen's CUDA kernel computes it (``w * (x -
m) * rsqrt(var + eps) + s`` in float32, its last multiply and add one
fused multiply-add, rounded once to bf16), then the five SiLU steps or
nothing: on a CUDA tensor the act kernel's BatchNorm mode, one pass in
place of ATen's BatchNorm pass and the SiLU pass; on a CPU tensor
:func:`batch_norm_silu_bf16_plain` or :func:`batch_norm_bf16_plain`.
``models/layers.py::ConvBN`` decides when to call it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def sigmoid_bf16_plain(x: torch.Tensor) -> torch.Tensor:
    """bf16 sigmoid in four torch ops, each rounded: 1 / (1 + exp(-x))."""
    return 1 / (1 + torch.exp(-x))


def silu_bf16_plain(x: torch.Tensor) -> torch.Tensor:
    """bf16 SiLU in five torch ops, each rounded: x * (1 / (1 + exp(-x)))."""
    return x * sigmoid_bf16_plain(x)


def silu_bias_bf16_plain(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """bf16 SiLU of ``x`` (N, C, H, W) plus ``bias`` (C,) over its channel
    axis: the float sum rounded once to bf16 (ATen's bf16 add), then
    :func:`silu_bf16_plain`."""
    return silu_bf16_plain((x.float() + bias.float()[:, None, None]).bfloat16())


# the act kernel's BatchNorm mode stages each channel in shared memory
# (csrc/act.cu's kMaxBnChannels); a wider BatchNorm stays on ATen's
BN_ACT_MAX_CHANNELS = 2048


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors rounded once to float32, as a
    fused multiply-add rounds it: the product is exact in float64, the
    float64 sum is rounded to odd (its error from Knuth's two-sum), and
    rounding that to float32 is the exact sum's rounding (53 >= 24 + 2
    bits)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    bits = s.view(torch.int64)
    # inexact with an even last bit: the odd neighbour on the error's side
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & (bits & 1 == 0), bits + step, bits)
    return bits.view(torch.float64).float()


def batch_norm_bf16_plain(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                          weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """An eval BatchNorm of a bf16 ``x`` (N, C, H, W) over its channel axis
    as ATen's CUDA kernel computes it: ``invstd = rsqrt(var + eps)`` in
    float32 (the device's own ``rsqrt``), ``weight * (x - mean)`` in
    float32, times ``invstd`` plus ``bias`` in one fused multiply-add
    (:func:`fma_f32`), rounded once to bf16."""
    def col(t: torch.Tensor) -> torch.Tensor:
        return t.float()[:, None, None]

    invstd = torch.rsqrt(var.float() + eps)
    return fma_f32(col(weight) * (x.float() - col(mean)), col(invstd), col(bias)).bfloat16()


def batch_norm_silu_bf16_plain(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                               weight: torch.Tensor, bias: torch.Tensor,
                               eps: float) -> torch.Tensor:
    """:func:`silu_bf16_plain` of :func:`batch_norm_bf16_plain`."""
    return silu_bf16_plain(batch_norm_bf16_plain(x, mean, var, weight, bias, eps))


def sigmoid_bf16_grad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The bf16 sigmoid's gradient as ``jax.vjp`` rounds it: ``g * (s * (1
    - s))``, each op rounded, ``s`` the four-step sigmoid of ``x``."""
    s = sigmoid_bf16_plain(x)
    return g * (s * (1 - s))


def silu_bf16_grad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The bf16 SiLU's gradient as ``jax.vjp`` rounds it: ``g * s + (x *
    g) * (s * (1 - s))``, each op rounded, ``s`` the four-step sigmoid."""
    s = sigmoid_bf16_plain(x)
    return g * s + (x * g) * (s * (1 - s))


def _backward(x: torch.Tensor, g: torch.Tensor, silu: bool) -> torch.Tensor:
    if x.is_cuda:
        from litepi_tpu_torch.kernels.act import act_bf16_backward_cuda

        return act_bf16_backward_cuda(x, g, silu)
    if x.device.type != "cpu":
        raise ValueError(f"no bf16 activation for device {x.device}")
    return silu_bf16_grad_plain(x, g) if silu else sigmoid_bf16_grad_plain(x, g)


class _ActBf16(torch.autograd.Function):
    """The bf16 activation with JAX's rounded gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, silu: bool) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.silu = silu
        return _act(x, silu)  # grad mode is off here: the forward alone

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        return _backward(x, g.to(torch.bfloat16), ctx.silu), None


def _act(x: torch.Tensor, silu: bool) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        return F.silu(x) if silu else torch.sigmoid(x)
    if x.requires_grad and torch.is_grad_enabled():
        return _ActBf16.apply(x, silu)
    if x.is_cuda:
        from litepi_tpu_torch.kernels.act import act_bf16_cuda

        return act_bf16_cuda(x, silu)
    if x.device.type != "cpu":
        raise ValueError(f"no bf16 activation for device {x.device}")
    return silu_bf16_plain(x) if silu else sigmoid_bf16_plain(x)


def silu(x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SiLU of ``x``, or of ``x`` plus ``bias`` (C,) over the channel axis of
    an (N, C, H, W) ``x``; in bf16 each of its five steps rounded, as the
    JAX program, and the bias add rounded before them."""
    if bias is None:
        return _act(x, True)
    if x.dtype != torch.bfloat16 or (
            torch.is_grad_enabled() and (x.requires_grad or bias.requires_grad)):
        return _act(x + bias[:, None, None], True)
    if x.is_cuda:
        from litepi_tpu_torch.kernels.act import act_bias_bf16_cuda

        return act_bias_bf16_cuda(x, bias)
    if x.device.type != "cpu":
        raise ValueError(f"no bf16 activation for device {x.device}")
    return silu_bias_bf16_plain(x, bias)


def batch_norm_act(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                   weight: torch.Tensor, bias: torch.Tensor, eps: float,
                   with_silu: bool) -> torch.Tensor:
    """An eval BatchNorm of a bf16 ``x`` (N, C, H, W) with running
    statistics ``mean`` and ``var`` and parameters ``weight`` and ``bias``
    (float32, (C,)), then SiLU (``with_silu``) or nothing, rounded as ATen's
    CUDA BatchNorm and the port's SiLU round them; no autograd."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bf16, got {x.dtype}")
    if x.is_cuda:
        from litepi_tpu_torch.kernels.act import bn_act_bf16_cuda

        return bn_act_bf16_cuda(x, mean, var, weight, bias, eps, with_silu)
    if x.device.type != "cpu":
        raise ValueError(f"no bf16 activation for device {x.device}")
    plain = batch_norm_silu_bf16_plain if with_silu else batch_norm_bf16_plain
    return plain(x, mean, var, weight, bias, eps)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Sigmoid; in bf16 each of its four steps rounded, as the JAX program."""
    return _act(x, False)
