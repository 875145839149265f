"""Portable program export via ``torch.export``.

The port's counterpart of the JAX package's ``weights/export.py`` (a
serialized StableHLO program).  A model's inference program, weights baked
in, is exported with ``torch.export`` and saved with ``torch.export.save``
into bytes that another process loads and runs without the model code:

    blob = export_classifier("shufflenetv2", variables, 91, input_size=64)
    path.write_bytes(blob)
    ...
    fn = load_program(path.read_bytes())
    logits = fn(x)

The program keeps the JAX package's boundary: (B, S, S, 3) NHWC float32 in,
a classifier's (B, num_classes) logits or a detector's ``{reg, cls}`` head
output out, on the device it was exported on, float32 with TF32 off.
Weights come as the Flax-named variable trees the port's importers return
and its checkpoint holds.
"""

from __future__ import annotations

import io
from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch
from torch import nn

from litepi_tpu_torch.core.device import resolve_device
from litepi_tpu_torch.weights.graph_ops import float32_exact, tf32_allowed
from litepi_tpu_torch.weights.jax_bridge import jax_to_state_dict


class _NhwcProgram(nn.Module):
    """``model`` behind the JAX boundary: NHWC float32 in."""

    def __init__(self, model: nn.Module) -> None:
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor):
        return self.model(x.permute(0, 3, 1, 2))


def export_program(module: nn.Module, example_args: Sequence[torch.Tensor]) -> bytes:
    """Export ``module`` (shaped by ``example_args``) with ``torch.export``
    and serialize it with ``torch.export.save``."""
    with tf32_allowed(False), torch.no_grad():
        program = torch.export.export(module, tuple(example_args))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_program(data: bytes) -> Callable:
    """Deserialize :func:`export_program` bytes into a callable that runs in
    float32 with TF32 off."""
    program = torch.export.load(io.BytesIO(data)).module()

    def run(*args):
        with float32_exact():
            return program(*args)

    return run


def _export(model: nn.Module, variables: Dict[str, Any], input_size: int, batch: int,
            device) -> bytes:
    dev = resolve_device(device)
    model.load_state_dict(jax_to_state_dict(variables))
    program = _NhwcProgram(model.eval()).to(dev)
    example = torch.from_numpy(np.zeros((batch, input_size, input_size, 3), np.float32)).to(dev)
    return export_program(program, (example,))


def export_classifier(
    arch: str,
    variables: Dict[str, Any],
    num_classes: int,
    input_size: int = 64,
    batch: int = 1,
    device="cuda",
) -> bytes:
    """Export a classifier's inference program with its weights baked in:
    (batch, S, S, 3) float32 -> (batch, num_classes) logits.  ``variables``
    as the JAX package's (BatchNorm unfolded, the module form it builds)."""
    from litepi_tpu_torch.models import build_classifier

    return _export(build_classifier(arch, num_classes), variables, input_size, batch, device)


def export_detector(
    det_model: nn.Module,
    variables: Dict[str, Any],
    input_size: int = 640,
    batch: int = 1,
    device="cuda",
) -> bytes:
    """Export a detector's raw-head inference program ({reg, cls} contract;
    ``{pred}`` for the anchor-based YOLOv5n): (batch, S, S, 3) float32 in
    [0, 1] -> the head output.  ``det_model`` is the port's module
    (``YoloLitePi``, ``YoloV11``, ``YoloV5``) that ``variables`` fit."""
    return _export(det_model, variables, input_size, batch, device)
