"""Wrapper of YOLO-World's class-head GEMM (``csrc/vocab.cu``).

A port-only kernel: YOLO-World has no counterpart in the JAX package.  Per
level of the head it takes the place of three passes, the biased 512 ->
nc 1x1 conv (``cls{i}_out``), the conv's bias add and the float32 copy of
the level's logits into the (B, A, nc) tensor, and writes that tensor's
rows of the level once.  The plain version is :func:`vocab_logits_plain`,
which is those three passes.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from litepi_tpu_torch.kernels import LAUNCHES
from litepi_tpu_torch.kernels.build import check, load

K_STEP = 64  # the kernel's K is a multiple of this


def _lib() -> ctypes.CDLL:
    lib = load("vocab")
    fn = lib.litepi_vocab_gemm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def takes_vocab_kernel(x: torch.Tensor, conv: torch.nn.Conv2d) -> bool:
    """Whether the class conv ``conv`` on ``x`` runs as the kernel: ``x`` a
    bf16 CUDA tensor and no gradient to record.  Whatever else the kernel
    needs of such an ``x`` (dense channels last, K a multiple of 64) is
    :func:`vocab_logits_cuda`'s to check, and it raises where ``x`` falls
    short: on the card in bf16 there is no way back to the plain path."""
    return (x.is_cuda and x.dtype == torch.bfloat16
            and not (torch.is_grad_enabled() and (
                x.requires_grad or any(p.requires_grad for p in conv.parameters()))))


def vocab_logits_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       out: torch.Tensor, a0: int) -> None:
    """Write ``conv2d(x, weight, bias)``, flattened to (B, H*W, nc), into
    ``out[:, a0:a0 + H*W]`` as float32: the biased conv in ``x``'s dtype
    (on the card: cuDNN's product, then ATen's bias add), then the copy."""
    b, _, h, w = x.shape
    y = F.conv2d(x, weight, bias)
    out[:, a0:a0 + h * w].copy_(y.permute(0, 2, 3, 1).reshape(b, h * w, -1))


def vocab_logits_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      out: torch.Tensor, a0: int) -> None:
    """:func:`vocab_logits_plain` as one kernel launch: ``x`` (B, K, H, W)
    bf16 dense channels last on the card, ``weight`` (nc, K, 1, 1) and
    ``bias`` (nc,) bf16 on its device, ``out`` a contiguous float32 (B, A,
    nc) tensor there with ``a0 + H*W <= A``.  Each value is the conv's bf16
    output plus the bias, rounded to bf16 as ATen's add rounds it; only the
    order of the float32 sum differs from the plain version on the card.  K
    is a multiple of 64; raises on anything the kernel does not take."""
    if not x.is_cuda or x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous(
            memory_format=torch.channels_last):
        raise ValueError(f"x must be a dense channels-last 4-D bf16 CUDA tensor, got "
                         f"{x.dim()}-D {x.dtype} on {x.device} with strides {x.stride()}")
    b, k, h, w = x.shape
    nc = weight.shape[0]
    if k % K_STEP or k == 0:
        raise ValueError(f"x has {k} channels; the kernel takes a multiple of {K_STEP}")
    if (weight.device != x.device or weight.dtype != torch.bfloat16
            or tuple(weight.shape) != (nc, k, 1, 1)):
        raise ValueError(f"weight must be a bf16 ({nc}, {k}, 1, 1) tensor on {x.device}, got "
                         f"{tuple(weight.shape)} {weight.dtype} on {weight.device}")
    if (bias is None or bias.device != x.device or bias.dtype != torch.bfloat16
            or tuple(bias.shape) != (nc,) or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous bf16 ({nc},) tensor on {x.device}")
    if (out.device != x.device or out.dtype != torch.float32 or out.dim() != 3
            or out.shape[0] != b or out.shape[2] != nc or not out.is_contiguous()
            or not 0 <= a0 <= out.shape[1] - h * w):
        raise ValueError(f"out must be a contiguous float32 ({b}, A, {nc}) tensor on {x.device} "
                         f"with {a0} + {h * w} <= A, got {tuple(out.shape)} {out.dtype}")
    w2 = weight.reshape(nc, k).contiguous()
    if x.data_ptr() % 16 or w2.data_ptr() % 16 or out.data_ptr() % 16 or bias.data_ptr() % 4:
        raise ValueError("x, weight and out must start on 16-byte boundaries, bias on 4")
    if x.numel() == 0:
        return
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.litepi_vocab_gemm(x.data_ptr(), w2.data_ptr(), bias.data_ptr(),
                                       out.data_ptr(), b * h * w, k, nc, h * w, out.shape[1],
                                       a0, stream)
    check(status, "vocab_gemm launch")
    LAUNCHES["vocab_gemm"] += 1
