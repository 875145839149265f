"""Ops shared by the port's three graph interpreters (``run_ncnn_graph``,
``run_onnx_graph``, ``run_ir_graph``): the torch forms of what the JAX
interpreters compute with XLA convolutions and numpy.

Every op runs on the tensors' own device.  The interpreters run in float32
with TF32 off (:func:`float32_exact`): a reduced-precision float32 matmul
moved decoded boxes by 3.3 px in the JAX package's parity work
(PARITY.md), so graph checks hold the card to full float32.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def tf32_allowed(allowed: bool) -> Iterator[None]:
    """TF32 allowed (or not) for cuDNN convolutions and matmuls, the
    caller's flags restored on exit."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = allowed
    torch.backends.cuda.matmul.allow_tf32 = allowed
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@contextlib.contextmanager
def float32_exact() -> Iterator[None]:
    """Inference mode with TF32 off (:func:`tf32_allowed`)."""
    with tf32_allowed(False), torch.inference_mode():
        yield


def tensor(a, device: torch.device) -> torch.Tensor:
    """A numpy array (or scalar) as a tensor on ``device``, its dtype kept."""
    return torch.from_numpy(np.array(a)).to(device)


def to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    stride: Sequence[int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]],
    dilation: Sequence[int],
    groups: int = 1,
) -> torch.Tensor:
    """float32 NCHW convolution with OIHW weights and ``((top, bottom),
    (left, right))`` zero padding, as ``lax.conv_general_dilated``."""
    (pt, pb), (pl, pr) = pads
    x = x.float()
    if pt == pb and pl == pr:
        return F.conv2d(x, w.float(), None, tuple(stride), (pt, pl), tuple(dilation), groups)
    x = F.pad(x, (pl, pr, pt, pb))
    return F.conv2d(x, w.float(), None, tuple(stride), 0, tuple(dilation), groups)


def max_pool(
    x: torch.Tensor,
    kernel: Sequence[int],
    stride: Sequence[int],
    pads: Tuple[Tuple[int, int], Tuple[int, int]],
) -> torch.Tensor:
    """Max pooling over the last two axes, padded with -inf, floor mode."""
    (pt, pb), (pl, pr) = pads
    xp = F.pad(x, (pl, pr, pt, pb), value=float("-inf"))
    lead = xp.shape[:-2]
    y = F.max_pool2d(xp.reshape(-1, 1, *xp.shape[-2:]), tuple(kernel), tuple(stride))
    return y.reshape(*lead, *y.shape[-2:])


def swish(x: torch.Tensor) -> torch.Tensor:
    return x / (1.0 + torch.exp(-x))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


def softmax(x: torch.Tensor, axis: int) -> torch.Tensor:
    e = torch.exp(x - x.amax(dim=axis, keepdim=True))
    return e / e.sum(dim=axis, keepdim=True)


def repeat_nearest(x: torch.Tensor, factors: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Nearest upsampling by integer ``(axis, factor)`` pairs."""
    for axis, f in factors:
        x = x.repeat_interleave(int(f), dim=axis)
    return x


def take(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``np.take(x, idx, axis)``: ``idx``'s shape replaces ``axis``."""
    axis = axis % x.dim()
    flat = idx.reshape(-1).long() % x.shape[axis]
    y = x.index_select(axis, flat)
    return y.reshape((*x.shape[:axis], *idx.shape, *x.shape[axis + 1:]))


def split(x: torch.Tensor, axis: int, sizes: Sequence[int]):
    """Consecutive pieces of ``sizes`` along ``axis``."""
    out, off = [], 0
    for size in sizes:
        out.append(x.narrow(axis, off, int(size)))
        off += int(size)
    return out
