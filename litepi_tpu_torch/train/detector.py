"""Detector training step, the port's copy of the JAX package's
``litepi_tpu/train/detector.py``.

One step: a forward in ``dtype`` over float32 master parameters (in bf16
every conv takes its weights cast to bf16 and BatchNorm keeps its float32
parameters and statistics, as a flax model with ``dtype=bf16`` computes),
the TAL + CIoU + DFL + BCE loss in float32, the gradient, the optimizer
update and the BatchNorm statistics update (flax's semantics,
``models/layers.py::batch_norm_train``), then the parameters' EMA.  The optimizer
is the JAX trainer's optax chain in its order: global-norm clip 10, weight
decay 5e-4 on every leaf, nesterov SGD 0.937 over the Ultralytics one-cycle
schedule (``train/optim.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from litepi_tpu_torch.core.device import resolve_device
from litepi_tpu_torch.core.types import DetectorConfig
from litepi_tpu_torch.models import YoloLitePi
from litepi_tpu_torch.ops.anchors import make_anchors
from litepi_tpu_torch.parallel.mesh import Mesh, all_reduce_flat, global_batch
from litepi_tpu_torch.train import optim
from litepi_tpu_torch.train.losses import detection_loss

# flax's lecun_normal: a normal truncated to +-2 standard deviations,
# rescaled to unit variance by this factor
_TRUNC_STD = 0.87962566103423978


def flax_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise ``model`` in place as the JAX package's ``fast_init``
    initialises its flax counterpart (the same distributions, not the same
    numbers): conv and linear weights lecun-normal (truncated normal of
    variance 1 / fan_in), biases 0, BatchNorm scale 1, bias 0, statistics
    (0, 1).  Draws in module order from ``generator`` (a CPU generator)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                std = (1.0 / m.weight[0].numel()) ** 0.5 / _TRUNC_STD
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model


def compute_params(model: nn.Module, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The parameters a forward in ``dtype`` reads: every conv's weight and
    bias cast to ``dtype`` (with autograd to the float32 master), the rest
    (BatchNorm, the classifiers' float32 Dense) as they are.  Empty for a
    float32 forward."""
    if dtype == torch.float32:
        return {}
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            for pname, p in m.named_parameters(recurse=False):
                out[f"{name}.{pname}" if name else pname] = p.to(dtype)
    return out


def forward_in(model: nn.Module, dtype: torch.dtype, x: torch.Tensor):
    """``model(x)`` with ``x`` and its convs in ``dtype``
    (:func:`compute_params`), as a flax model with that ``dtype`` casts its
    input and its conv kernels."""
    cast = compute_params(model, dtype)
    if not cast:
        return model(x)
    return torch.func.functional_call(model, cast, (x.to(dtype),), strict=False)


@dataclasses.dataclass
class DetectorTrainState:
    """The model (float32 master parameters and BatchNorm statistics), the
    momentum trace (``opt_state["trace"]``, one tensor per parameter in
    ``model.named_parameters()`` order), the step count and the EMA of the
    parameters (None with EMA off), and the forward's ``dtype``."""

    model: nn.Module
    opt_state: Dict[str, Any]
    step: int
    ema_params: Optional[Dict[str, torch.Tensor]]
    dtype: torch.dtype = torch.bfloat16

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


@dataclasses.dataclass(frozen=True)
class DetectorOptimizer:
    """The JAX trainer's optax chain: ``clip_by_global_norm(10)``,
    ``add_decayed_weights(weight_decay)``, ``sgd(schedule, momentum,
    nesterov=True)``."""

    schedule: optim.Schedule
    weight_decay: float = 5e-4
    momentum: float = 0.937
    max_norm: float = 10.0

    def init(self, params) -> Dict[str, Any]:
        return {"trace": [torch.zeros_like(p) for p in params]}

    def update_(self, params, grads, opt_state, step: int) -> None:
        """Apply one update to ``params`` in place at optimizer count
        ``step``."""
        with torch.no_grad():
            g = optim.clip_by_global_norm(list(grads), self.max_norm)
            g = optim.add_decayed_weights(g, params, self.weight_decay)
            u = optim.nesterov_trace(g, opt_state["trace"], self.momentum)
            optim.apply_updates(params, u, self.schedule(step))


def make_lr_schedule(
    lr: float, total_steps: int, warmup_steps: int = 0, final_lr_fraction: float = 0.01
) -> optim.Schedule:
    """The Ultralytics one-cycle shape: linear warmup from lr/10, cosine
    decay to ``lr * final_lr_fraction``."""
    return optim.warmup_cosine_decay_schedule(
        init_value=lr / 10.0,
        peak_value=lr,
        warmup_steps=max(warmup_steps, 1),
        decay_steps=max(total_steps, warmup_steps + 1),
        end_value=lr * final_lr_fraction,
    )


def make_optimizer(
    lr: float = 1e-2,
    weight_decay: float = 5e-4,
    momentum: float = 0.937,
    total_steps: int = 0,
    warmup_steps: int = 0,
    final_lr_fraction: float = 0.01,
) -> DetectorOptimizer:
    """SGD + nesterov momentum + weight decay; with ``total_steps`` > 0 the
    one-cycle schedule, else a constant ``lr``."""
    schedule = (
        make_lr_schedule(lr, total_steps, warmup_steps, final_lr_fraction)
        if total_steps > 0
        else optim.constant_schedule(lr)
    )
    return DetectorOptimizer(schedule, weight_decay, momentum)


def create_detector_train_state(
    cfg: DetectorConfig,
    seed: int = 0,
    lr: float = 1e-2,
    dtype: torch.dtype = torch.bfloat16,
    total_steps: int = 0,
    warmup_steps: int = 0,
    model: Optional[nn.Module] = None,
    device="cuda",
) -> Tuple[nn.Module, DetectorTrainState, DetectorOptimizer]:
    """(model, train state, optimizer), on ``device`` (the card unless the
    caller asks for the CPU).  ``model`` overrides the default YoloLitePi
    (any detector with the ``{reg, cls}`` head: YoloV11, YoloV5 anchor-free);
    ``cfg`` then supplies the anchor grid and ``reg_max`` of the loss.
    Weights from :func:`flax_init_` with a generator seeded ``seed``."""
    device = resolve_device(device)
    if model is None:
        model = YoloLitePi(cfg)
    flax_init_(model, torch.Generator().manual_seed(seed))
    model = model.to(device).train()
    tx = make_optimizer(lr, total_steps=total_steps, warmup_steps=warmup_steps)
    params = list(model.parameters())
    state = DetectorTrainState(
        model=model,
        opt_state=tx.init(params),
        step=0,
        ema_params={k: p.detach().clone() for k, p in model.named_parameters()},
        dtype=dtype,
    )
    return model, state, tx


_ANCHORS: Dict[Tuple[int, Tuple[int, ...], str], Tuple[torch.Tensor, torch.Tensor]] = {}


def _anchors(cfg: DetectorConfig, device: torch.device):
    key = (cfg.input_size, tuple(cfg.strides), str(device))
    if key not in _ANCHORS:
        pts, strides = make_anchors(cfg.input_size, cfg.strides)
        _ANCHORS[key] = (torch.as_tensor(pts, device=device),
                         torch.as_tensor(strides, device=device))
    return _ANCHORS[key]


def to_device_batch(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy, the datasets' layout) on ``device``: images
    NHWC -> NCHW float32 (through pinned memory on the card)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    if "images" in out:
        out["images"] = out["images"].permute(0, 3, 1, 2)
    return out


def detector_train_step(
    model: nn.Module,
    tx: DetectorOptimizer,
    state: DetectorTrainState,
    batch: Dict[str, torch.Tensor],
    cfg: Optional[DetectorConfig] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[DetectorTrainState, Dict[str, torch.Tensor]]:
    """One optimization step, in place on ``state``.

    ``batch`` on the model's device (:func:`to_device_batch`): images (B,
    3, S, S) float32 in [0, 1] RGB; gt_boxes (B, G, 4) xyxy pixels
    (padded); gt_labels (B, G); gt_mask (B, G) bool.  ``cfg`` (anchor grid
    and ``reg_max`` of the loss) defaults to ``model.cfg``.  Returns the
    state and ``{"loss", "loss_box", "loss_cls", "loss_dfl", "num_fg"}`` as
    device tensors (nothing is read back).

    With ``mesh`` (``parallel/mesh.py``) over several data ranks, ``batch``
    is this rank's rows of the global batch and the step is the global
    batch's, as the JAX step under a data-sharded ``jit``: BatchNorm's
    moments and the loss's normaliser are global, the parameter gradients
    are summed over the ranks (not averaged: the loss already divides by
    global counts) and the metrics are the global batch's, so the
    optimizer, the EMA and the BatchNorm statistics stay identical on every
    rank.  One rank (or no mesh) changes nothing."""
    cfg = cfg if cfg is not None else model.cfg
    model.train()
    anchors, strides = _anchors(cfg, batch["images"].device)
    params = list(model.parameters())
    with global_batch(mesh):
        out = forward_in(model, state.dtype, batch["images"])
        loss, aux = detection_loss(
            out, anchors, strides, batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"],
            reg_max=cfg.reg_max,
        )
        grads = torch.autograd.grad(loss, params)
    metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}
    group = mesh.data_group if mesh is not None else None
    grads = all_reduce_flat(grads, group)
    metrics = all_reduce_metrics(metrics, group)
    tx.update_(params, grads, state.opt_state, state.step)
    state.step += 1
    if state.ema_params is not None:
        with torch.no_grad():
            optim.ema_update(list(state.ema_params.values()), params, state.step)
    return state, metrics


def all_reduce_metrics(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Scalar metrics (per-rank shares of the global batch's sums) summed
    over ``group``'s ranks in one all-reduce, each in its own dtype; as
    they are without a group."""
    if group is None:
        return metrics
    summed = all_reduce_flat([torch.stack([v.double() for v in metrics.values()])], group)[0]
    return {k: s.to(v.dtype) for (k, v), s in zip(metrics.items(), summed)}
