"""Wrapper of the stem kernel (``csrc/stem.cu``).

Replaces the JAX package's Pallas kernel ``ops/pallas_stem.py::
pallas_stem``.  The plain version is ``ops/stem.py::stem_plain``.

For C = 16 and 32 the kernel takes its weights and bias by value, as a
kernel parameter, so they must be on the host at launch:
:func:`pack_stem_params` packs them once (``TwoStagePipeline`` does it when
it folds its stem), and :func:`stem_cuda` takes the packed tensor.

In bf16 out the kernel reads SiLU (its five bf16 steps, as the JAX program
rounds them) from :func:`silu_table`, made once per device.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from litepi_tpu_torch.kernels import LAUNCHES
from litepi_tpu_torch.kernels.act import act_bf16_cuda
from litepi_tpu_torch.kernels.build import check, load

MAX_CHANNELS = 256  # csrc/stem.cu kMaxChannels (generic path: weights in shared memory)
PARAM_CHANNELS = (16, 32)  # csrc/stem.cu stem_tiled_kernel: weights as kernel parameters
OUT_DTYPES = (torch.float32, torch.bfloat16)

# device -> the bf16 SiLU table; a constant, made at first use
_SILU_TABLES: Dict[torch.device, torch.Tensor] = {}


def _lib() -> ctypes.CDLL:
    lib = load("stem")
    fn = lib.litepi_stem
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def pack_stem_params(weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The kernel's parameter block: a (28, C) float32 CPU tensor, rows 0-26
    the (27, C) weight (HWIO taps in (dy, dx, ci) order) and row 27 the
    bias.  Copies from the card when the arguments are on it (a
    synchronisation): pack once, not per call."""
    if weight.dim() != 2 or weight.shape[0] != 27:
        raise ValueError(f"weight must be (27, C), got {tuple(weight.shape)}")
    c = int(weight.shape[1])
    if tuple(bias.shape) != (c,):
        raise ValueError(f"bias must be ({c},), got {tuple(bias.shape)}")
    w = weight.detach().to("cpu", torch.float32)
    b = bias.detach().to("cpu", torch.float32)
    return torch.cat([w, b[None]]).contiguous()


def silu_table(device: torch.device) -> torch.Tensor:
    """The bf16 SiLU of every bf16 value, each of its five steps rounded
    (``ops/act.py``), indexed by the value's 16-bit pattern: 65,536 values
    made on ``device`` by the activation kernel (one launch, counted), once.
    The bf16 stem's epilogue reads it."""
    table = _SILU_TABLES.get(device)
    if table is None:
        bits = torch.arange(1 << 16, dtype=torch.int32, device=device).to(torch.int16)
        table = act_bf16_cuda(bits.view(torch.bfloat16), silu=True)
        _SILU_TABLES[device] = table
    return table


def stem_cuda(
    frames: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    out_dtype: torch.dtype,
    params: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, C, H/2, W/2) NCHW stem activations in ``out_dtype`` (float32 or
    bfloat16) from frames (B, H, W, 3) uint8 with H and W even, weight
    (27, C) float32 (HWIO taps in (dy, dx, ci) order) and bias (C,)
    float32, all contiguous on one CUDA device.  ``params`` is
    ``pack_stem_params(weight, bias)``, packed once by the caller; for C in
    :data:`PARAM_CHANNELS` the kernel reads its weights from it alone, and
    a call without it raises (packing here would copy from the card, a
    synchronisation)."""
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
    if b > 65535:
        raise ValueError(f"batch {b} > 65535 (the kernel's grid)")
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
    if params is not None:
        if (params.device.type != "cpu" or params.dtype != torch.float32
                or tuple(params.shape) != (28, c) or not params.is_contiguous()):
            raise ValueError(
                f"params must be a contiguous (28, {c}) float32 CPU tensor "
                f"(pack_stem_params), got {tuple(params.shape)} {params.dtype} "
                f"on {params.device}"
            )
    elif c in PARAM_CHANNELS:
        raise ValueError(
            f"C={c} takes its weights from params: pass pack_stem_params(weight, bias)"
        )
    out = torch.empty((b, c, h // 2, w // 2), dtype=out_dtype, device=dev)
    if b == 0 or h == 0 or w == 0:
        return out
    table = silu_table(dev) if out_dtype == torch.bfloat16 else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = _lib().litepi_stem(
            frames.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            0 if params is None else params.data_ptr(),
            0 if table is None else table.data_ptr(), out.data_ptr(),
            b, h, w, c, int(out_dtype == torch.bfloat16), stream,
        )
    check(status, "stem launch")
    LAUNCHES["stem"] += 1
    return out
