"""Train steps of the baseline detectors (Faster R-CNN, SSD300), the
port's copy of the loops of the JAX package's ``apps/train_baselines.py``.

The reference's recipes (train-other-model-tsd-tt100k.ipynb cells 11 and
13), as the JAX CLI chains them in optax:

* **faster_rcnn**: ``add_decayed_weights(5e-4)`` then ``sgd(momentum=0.9)``
  (weight decay before the momentum trace, as torch's SGD) over a StepLR:
  ``piecewise_constant_schedule`` with a factor 0.1 every 3 epochs;
  BatchNorm statistics updated as flax's ``mutable=["batch_stats"]``.
* **ssd300**: ``adamw(weight_decay=1e-4)`` over ``cosine_decay_schedule``
  to 0 at the last step.

Faster R-CNN takes a bf16 forward over float32 master parameters
(``train/detector.py::forward_in``: every conv's weights cast to bf16);
SSD300's bf16 is one rounding of its input (``models/ssd.py``).  The
Faster R-CNN loss's sampling draws come from a ``torch.Generator`` or are
given (``train/frcnn_loss.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from litepi_tpu_torch.core.device import resolve_device
from litepi_tpu_torch.models.faster_rcnn import FasterRCNN
from litepi_tpu_torch.models.ssd import SSD300
from litepi_tpu_torch.ops.boxes import xywh_to_xyxy
from litepi_tpu_torch.train import optim
from litepi_tpu_torch.train.detector import flax_init_, forward_in
from litepi_tpu_torch.train.frcnn_loss import Draws, frcnn_loss
from litepi_tpu_torch.train.ssd_loss import multibox_loss

ARCHS = ("faster_rcnn", "ssd300")


def step_lr_boundaries(epochs: int, steps_per_epoch: int) -> Dict[int, float]:
    """The JAX CLI's StepLR(step 3 epochs, gamma 0.1) as optax boundaries."""
    return {3 * k * steps_per_epoch: 0.1 for k in range(1, max(epochs // 3 + 1, 2))}


@dataclasses.dataclass(frozen=True)
class SGDMomentum:
    """``chain(add_decayed_weights(weight_decay), sgd(schedule,
    momentum))``."""

    schedule: optim.Schedule
    weight_decay: float = 5e-4
    momentum: float = 0.9

    def init(self, params) -> Dict[str, Any]:
        return {"trace": [torch.zeros_like(p) for p in params]}

    def update_(self, params, grads, opt_state, step: int) -> None:
        with torch.no_grad():
            g = optim.add_decayed_weights(list(grads), params, self.weight_decay)
            u = optim.momentum_trace(g, opt_state["trace"], self.momentum)
            optim.apply_updates(params, u, self.schedule(step))


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax's ``adamw(schedule, weight_decay)``: ``scale_by_adam``, the
    decoupled ``+ weight_decay * p``, then the rate."""

    schedule: optim.Schedule
    weight_decay: float = 1e-4

    def init(self, params) -> Dict[str, Any]:
        return {"mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update_(self, params, grads, opt_state, step: int) -> None:
        with torch.no_grad():
            u = optim.scale_by_adam(list(grads), opt_state["mu"], opt_state["nu"], step)
            u = optim.add_decayed_weights(u, params, self.weight_decay)
            optim.apply_updates(params, u, self.schedule(step))


@dataclasses.dataclass
class BaselineTrainState:
    """The model (float32 masters and BatchNorm statistics), the optimizer
    state, the step count and the forward's dtype."""

    arch: str
    model: nn.Module
    opt_state: Dict[str, Any]
    step: int
    dtype: torch.dtype = torch.bfloat16


def build_baseline(arch: str, num_classes: int, input_size: int, pre_nms_topk: int = 1024,
                   post_nms_topk: int = 256, dtype: torch.dtype = torch.float32) -> nn.Module:
    if arch == "faster_rcnn":
        return FasterRCNN(num_classes=num_classes, input_size=input_size,
                          pre_nms_topk=pre_nms_topk, post_nms_topk=post_nms_topk, dtype=dtype)
    if arch == "ssd300":
        return SSD300(num_classes=num_classes, dtype=dtype)
    raise ValueError(f"unknown baseline {arch!r}; choices: {ARCHS}")


def make_baseline_optimizer(arch: str, lr: float, epochs: int, steps_per_epoch: int):
    """The JAX CLI's optimizer of ``arch``."""
    if arch == "faster_rcnn":
        return SGDMomentum(optim.piecewise_constant_schedule(
            lr, step_lr_boundaries(epochs, steps_per_epoch)))
    return AdamW(optim.cosine_decay_schedule(lr, max(epochs * steps_per_epoch, 1)))


def create_baseline_train_state(
    arch: str,
    num_classes: int = 1,
    input_size: Optional[int] = None,
    seed: int = 0,
    lr: float = 1e-4,
    epochs: int = 30,
    steps_per_epoch: int = 1,
    pre_nms_topk: int = 1024,
    post_nms_topk: int = 256,
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
) -> Tuple[BaselineTrainState, Any]:
    """(train state, optimizer) on ``device`` (the card unless the caller
    asks for the CPU), weights from :func:`~litepi_tpu_torch.train.
    detector.flax_init_` seeded ``seed``."""
    device = resolve_device(device)
    size = input_size or (300 if arch == "ssd300" else 640)
    model = build_baseline(arch, num_classes, size, pre_nms_topk, post_nms_topk, dtype)
    flax_init_(model, torch.Generator().manual_seed(seed))
    model = model.to(device).train()
    tx = make_baseline_optimizer(arch, lr, epochs, steps_per_epoch)
    return BaselineTrainState(arch, model, tx.init(list(model.parameters())), 0, dtype), tx


def baseline_loss(state: BaselineTrainState, batch: Dict[str, torch.Tensor],
                  draws: Optional[Draws] = None):
    """(loss, aux, forward output) of one batch on device (images NCHW
    float32 in [0, 1], padded gt boxes / labels / mask), BatchNorm in
    train mode (its statistics move)."""
    model = state.model
    model.train()
    if state.arch == "faster_rcnn":
        if draws is None:
            raise ValueError("the Faster R-CNN loss needs its sampling draws or a generator")
        out = forward_in(model, state.dtype, batch["images"])
        loss, aux = frcnn_loss(out, batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"],
                               draws)
    else:
        out = model(batch["images"])  # rounds its input to model.dtype once
        db = model.default_boxes
        loss, aux = multibox_loss(out, xywh_to_xyxy(db), db, batch["gt_boxes"],
                                  batch["gt_labels"], batch["gt_mask"])
    return loss, aux, out


def baseline_train_step(state: BaselineTrainState, tx, batch: Dict[str, torch.Tensor],
                        draws: Optional[Draws] = None):
    """One optimization step in place on ``state``: the loss, its gradient
    with respect to the float32 masters, the optimizer update.  ``draws``
    (Faster R-CNN only): the loss's four uniform tensors or a
    ``torch.Generator``.  Returns (state, metrics as device tensors)."""
    loss, aux, _ = baseline_loss(state, batch, draws)
    params = list(state.model.parameters())
    grads = torch.autograd.grad(loss, params)
    tx.update_(params, grads, state.opt_state, state.step)
    state.step += 1
    return state, {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}
