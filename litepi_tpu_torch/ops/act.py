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


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Sigmoid; in bf16 each of its four steps rounded, as the JAX program."""
    return _act(x, False)
