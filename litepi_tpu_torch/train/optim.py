"""The optax transforms the JAX trainers chain, as plain functions of
tensor lists (``torch._foreach_*``, one pass per op over every leaf).

Each keeps optax's arithmetic in its order: ``clip_by_global_norm``
(``(g / norm) * max_norm`` where the norm reaches ``max_norm``),
``add_decayed_weights`` (``g + wd * p``), ``trace`` with nesterov (``t' =
g + m * t``, update ``g + m * t'``) or without (update ``t'``: ``sgd``'s
momentum), ``scale_by_adam`` (moments ``(1 - b) * g + b * m``, bias
correction ``m / (1 - b^count)``, ``mu / (sqrt(nu) + eps)``), the learning
rate applied as ``-lr * u``; ``adamw`` is ``scale_by_adam``, then the
decoupled ``+ wd * p``, then the rate.  Schedules are functions of the
integer step (``warmup_cosine_decay_schedule``, ``cosine_decay_schedule``,
``piecewise_constant_schedule``), optax's formulas evaluated in float64 and
rounded once to float32 (the piecewise one in float32 steps, as optax
multiplies): XLA rewrites optax's float32 program (a divide by a constant
becomes a multiply by its reciprocal, constants fold), so its values sit
within 2 float32 ulps of these.  They go to the device as Python floats, so
a step needs no host synchronisation.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence

import numpy as np
import torch

Schedule = Callable[[int], float]
Tensors = List[torch.Tensor]


def _f32(v: float) -> float:
    """``v`` rounded to the nearest float32, as a Python float."""
    return float(np.float32(v))


def warmup_cosine_decay_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float = 0.0,
) -> Schedule:
    """optax's ``warmup_cosine_decay_schedule`` (exponent 1): linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine to
    ``end_value`` at ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = 1 - min(max(step, 0), warmup_steps) / warmup_steps
            return _f32((init_value - peak_value) * frac + peak_value)
        return cosine(step - warmup_steps)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax's ``cosine_decay_schedule`` (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, got {decay_steps}")

    def schedule(step: int) -> float:
        cosine = 0.5 * (1 + math.cos(math.pi * min(step, decay_steps) / decay_steps))
        return _f32(init_value * ((1 - alpha) * cosine + alpha))

    return schedule


def piecewise_constant_schedule(init_value: float, boundaries_and_scales) -> Schedule:
    """optax's ``piecewise_constant_schedule``: ``init_value`` times the
    scale of every boundary the step has reached (``step >= boundary``),
    multiplied in float32 in boundary order."""
    pairs = sorted((int(k), float(v)) for k, v in dict(boundaries_and_scales).items())

    def schedule(step: int) -> float:
        v = np.float32(init_value)
        for boundary, scale in pairs:
            if step >= boundary:
                v = np.float32(v * np.float32(scale))
        return float(v)

    return schedule


def constant_schedule(value: float) -> Schedule:
    return lambda step: _f32(value)


def clip_by_global_norm(grads: Tensors, max_norm: float) -> Tensors:
    """optax's ``clip_by_global_norm``: ``grads`` unchanged when their
    global L2 norm is below ``max_norm``, else each ``(g / norm) *
    max_norm``.  The choice is made on the device (each leaf times 1 or 0
    and summed, exact for finite values), so no value is read back."""
    norms = torch._foreach_norm(grads)
    norm = torch.linalg.vector_norm(torch.stack(norms))
    keep = (norm < max_norm).to(grads[0].dtype)
    clipped = torch._foreach_mul(torch._foreach_div(grads, norm), max_norm)
    return torch._foreach_add(torch._foreach_mul(grads, keep),
                              torch._foreach_mul(clipped, 1 - keep))


def add_decayed_weights(grads: Tensors, params: Sequence[torch.Tensor], weight_decay: float) -> Tensors:
    return torch._foreach_add(grads, torch._foreach_mul(list(params), weight_decay))


def nesterov_trace(grads: Tensors, trace: Tensors, decay: float) -> Tensors:
    """optax's ``trace(decay, nesterov=True)``: updates ``trace`` in place
    to ``g + decay * t`` and returns ``g + decay * t_new`` (an addition's
    operand order does not change its rounding)."""
    torch._foreach_mul_(trace, decay)
    torch._foreach_add_(trace, grads)  # decay * t + g, as g + decay * t rounds
    return torch._foreach_add(grads, torch._foreach_mul(trace, decay))


def momentum_trace(grads: Tensors, trace: Tensors, decay: float) -> Tensors:
    """optax's ``trace(decay, nesterov=False)`` (``sgd``'s momentum):
    updates ``trace`` in place to ``g + decay * t`` and returns it."""
    torch._foreach_mul_(trace, decay)
    torch._foreach_add_(trace, grads)  # decay * t + g, as g + decay * t rounds
    return list(trace)


def scale_by_adam(
    grads: Tensors, mu: Tensors, nu: Tensors, count: int,
    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
) -> Tensors:
    """optax's ``scale_by_adam`` at the state's ``count`` (before its
    increment); ``mu`` and ``nu`` are updated in place."""
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
    corr1 = _f32(1 - b1 ** (count + 1))
    corr2 = _f32(1 - b2 ** (count + 1))
    mu_hat = torch._foreach_div(mu, corr1)
    nu_hat = torch._foreach_div(nu, corr2)
    denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), eps)
    return torch._foreach_div(mu_hat, denom)


def apply_updates(params: Sequence[torch.Tensor], updates: Tensors, lr: float) -> None:
    """``p + (-lr) * u`` in place: optax's ``scale_by_learning_rate`` and
    ``apply_updates``."""
    torch._foreach_add_(list(params), torch._foreach_mul(updates, -lr))


EMA_DECAY = 0.9999
EMA_TAU = 2000.0


def ema_decay(step: int) -> float:
    """The Ultralytics ModelEMA decay at ``step``, rounded to float32:
    0.9999 * (1 - exp(-step / 2000)), ramping towards 0.9999 so early
    training moves the EMA quickly."""
    return _f32(EMA_DECAY * (1 - math.exp(-step / EMA_TAU)))


def ema_update(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor], step: int) -> None:
    """``e * d + (1 - d) * p`` in place, with ``d = ema_decay(step)``."""
    d = ema_decay(step)
    one_minus = _f32(1 - d)
    ema = list(ema)
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, torch._foreach_mul(list(params), one_minus))
