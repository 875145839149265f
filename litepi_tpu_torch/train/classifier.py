"""Classifier training step, the port's copy of the JAX package's
``litepi_tpu/train/classifier.py``: cross-entropy over integer or soft
(MixUp / CutMix) labels, Adam over a cosine schedule after a global-norm
clip of 1.0 (the reference's recipe), the forward in ``dtype`` over float32
master parameters with the classifier's Dense in float32, dropout drawn
from a generator the caller passes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from litepi_tpu_torch.core.device import resolve_device
from litepi_tpu_torch.models.layers import Dropout, at_least_float32
from litepi_tpu_torch.train import optim
from litepi_tpu_torch.train.detector import flax_init_, forward_in


@dataclasses.dataclass
class ClassifierTrainState:
    """The model (float32 master parameters, BatchNorm statistics), Adam's
    moments and count (``opt_state``), the step count and the forward's
    ``dtype``."""

    model: nn.Module
    opt_state: Dict[str, Any]
    step: int
    dtype: torch.dtype = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class ClassifierOptimizer:
    """optax's ``chain(clip_by_global_norm(max_norm), adam(schedule))``."""

    schedule: optim.Schedule
    max_norm: float = 1.0

    def init(self, params) -> Dict[str, Any]:
        return {"mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params], "count": 0}

    def update_(self, params, grads, opt_state) -> None:
        with torch.no_grad():
            g = optim.clip_by_global_norm(list(grads), self.max_norm)
            count = opt_state["count"]
            u = optim.scale_by_adam(g, opt_state["mu"], opt_state["nu"], count)
            optim.apply_updates(params, u, self.schedule(count))
            opt_state["count"] = count + 1


def make_optimizer(lr: float = 1e-3, total_steps: int = 10_000) -> ClassifierOptimizer:
    """Adam + cosine decay + grad clip 1.0, the reference's recipe."""
    return ClassifierOptimizer(optim.cosine_decay_schedule(lr, total_steps))


def create_classifier_train_state(
    model: nn.Module,
    seed: int = 0,
    lr: float = 1e-3,
    total_steps: int = 10_000,
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
) -> Tuple[ClassifierTrainState, ClassifierOptimizer]:
    """(state, optimizer) for ``model`` on ``device`` (the card unless the
    caller asks for the CPU), weights from ``detector.py::flax_init_``."""
    device = resolve_device(device)
    flax_init_(model, torch.Generator().manual_seed(seed))
    model = model.to(device).train()
    tx = make_optimizer(lr, total_steps)
    return ClassifierTrainState(model, tx.init(list(model.parameters())), 0, dtype), tx


def classifier_train_step(
    model: nn.Module,
    tx: ClassifierOptimizer,
    state: ClassifierTrainState,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
) -> Tuple[ClassifierTrainState, Dict[str, torch.Tensor]]:
    """One CE step, in place on ``state``.  ``batch`` on the model's device:
    images (B, 3, c, c) normalised; labels (B,) integer or (B, nc) soft.
    ``generator`` (on that device) draws the dropout masks.  Returns the
    state and ``{"loss", "accuracy"}`` as device tensors."""
    model.train()
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
    out = at_least_float32(forward_in(model, state.dtype, batch["images"]))
    labels = batch["labels"]
    if labels.dim() == 1:
        labels = F.one_hot(labels.long(), out.shape[-1]).to(out.dtype)
    loss = -(labels * F.log_softmax(out, dim=-1)).sum(-1).mean()
    acc = (out.argmax(-1) == labels.argmax(-1)).float().mean()
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params)
    tx.update_(params, grads, state.opt_state)
    state.step += 1
    return state, {"loss": loss.detach(), "accuracy": acc.detach()}
