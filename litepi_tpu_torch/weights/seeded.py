"""Seeded random weights for a model of the port.

The port's counterpart of the JAX package's ``models/init_utils.py::
fast_init``: what the e2e CLI loads when no weights are given, and what
``chip_smoke.py`` draws its pipelines from.  The weights come from a
``torch.Generator`` seed and are not equal to JAX's random weights for the
same seed: the two frameworks draw different numbers.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def seeded_state(model: nn.Module, seed: int, gain: float = 1.0) -> Dict[str, torch.Tensor]:
    """``model``'s state with every conv and linear weight drawn from
    N(0, gain^2 / fan_in) (gain 1: lecun normal, the JAX models' init),
    biases 0 and BatchNorm at its identity init.  The model's own weights
    are overwritten."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * (gain / m.weight[0].numel() ** 0.5))
                if m.bias is not None:
                    m.bias.zero_()
    return model.state_dict()
