"""SiLU and sigmoid as the JAX program rounds them.

JAX writes flax's bf16 SiLU into its StableHLO as five bf16 ops (negate,
exponential, add 1, divide 1 by it, multiply by x) and ``jax.nn.sigmoid``
as the first four, so the JAX program rounds after each step on every
backend; torch's ``F.silu`` and ``torch.sigmoid`` round once (39.4% and
28.4% of bf16 SiLU values differ from JAX's on N(0, 3^2) inputs).  In bf16,
:func:`silu` and :func:`sigmoid` round at each step: the kernel
``csrc/act.cu`` on a CUDA tensor (one pass), the plain versions on a CPU
tensor.  Float32 stays on ``F.silu`` and ``torch.sigmoid``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_bf16_plain(x: torch.Tensor) -> torch.Tensor:
    """bf16 sigmoid in four torch ops, each rounded: 1 / (1 + exp(-x))."""
    return 1 / (1 + torch.exp(-x))


def silu_bf16_plain(x: torch.Tensor) -> torch.Tensor:
    """bf16 SiLU in five torch ops, each rounded: x * (1 / (1 + exp(-x)))."""
    return x * sigmoid_bf16_plain(x)


def _act(x: torch.Tensor, silu: bool) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        return F.silu(x) if silu else torch.sigmoid(x)
    if x.is_cuda:
        from litepi_tpu_torch.kernels.act import act_bf16_cuda

        return act_bf16_cuda(x, silu)
    if x.device.type != "cpu":
        raise ValueError(f"no bf16 activation for device {x.device}")
    return silu_bf16_plain(x) if silu else sigmoid_bf16_plain(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU; in bf16 each of its five steps rounded, as the JAX program."""
    return _act(x, True)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Sigmoid; in bf16 each of its four steps rounded, as the JAX program."""
    return _act(x, False)
