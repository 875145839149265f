"""The detector's stem on uint8 frames: 3x3 conv, stride 2, pad 1, + bias
+ SiLU (the JAX package's ``ops/pallas_stem.py``).

:func:`fused_stem` keeps the ``pallas_stem`` contract: frames (B, H, W, 3)
uint8 with H a multiple of 80 and W even, a (3, 3, 3, C) HWIO float32
kernel with the 1/255 input scale (and any colour flip) folded in
(``weights/fold_bn.py::stem_kernel_hwio``), a (C,) bias, and (B, H/2, W/2,
C) out in ``out_dtype``.  The 80 is the Pallas kernel's 40-row tiling;
the contract keeps it so that both packages take the same frames.

The output is a (B, H/2, W/2, C) view of NCHW memory, so that the
detector's next convolution gets the layout it gets from the cuDNN stem.
A CUDA tensor goes through the stem kernel (``csrc/stem.cu``), a CPU
tensor through :func:`stem_plain`.  The kernel takes its weights for C =
16 and 32 from the host (``kernels/stem.py::pack_stem_params``): pass them
packed once as ``params``; a CUDA call without them raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

ROW_MULTIPLE = 80  # pallas_stem: two 40-row output chunks


def stem_plain(
    frames: torch.Tensor,
    kernel_hwio: torch.Tensor,
    bias: torch.Tensor,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain version of the stem kernel, on any device: ``F.conv2d`` on the
    float32 frames, then the bias and ``F.silu``, then one cast.  Same
    arguments and result as :func:`fused_stem`."""
    x = frames.permute(0, 3, 1, 2).float()
    y = F.conv2d(x, kernel_hwio.float().permute(3, 2, 0, 1), stride=2, padding=1)
    y = F.silu(y + bias.float()[:, None, None])
    return y.to(out_dtype).contiguous().permute(0, 2, 3, 1)


def fused_stem(
    frames: torch.Tensor,
    kernel_hwio_folded: torch.Tensor,
    bias: torch.Tensor,
    out_dtype: torch.dtype = torch.bfloat16,
    params: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, H, W, 3) uint8 frames -> (B, H/2, W/2, C) stem activations in
    ``out_dtype``: the stem kernel on a CUDA tensor (weights from
    ``params`` where given), :func:`stem_plain` on a CPU tensor."""
    if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(
            f"frames must be (B, H, W, 3) uint8, got {tuple(frames.shape)} {frames.dtype}"
        )
    h, w = int(frames.shape[1]), int(frames.shape[2])
    if h % ROW_MULTIPLE or w % 2:
        raise ValueError(f"frame size {h}x{w} not supported by the stem kernel")
    if frames.is_cuda:
        from litepi_tpu_torch.kernels.stem import stem_cuda

        c = kernel_hwio_folded.shape[-1]
        out = stem_cuda(frames, kernel_hwio_folded.reshape(27, c), bias, out_dtype, params)
        return out.permute(0, 2, 3, 1)
    if frames.device.type != "cpu":
        raise ValueError(f"no stem for device {frames.device}")
    return stem_plain(frames, kernel_hwio_folded, bias, out_dtype)
