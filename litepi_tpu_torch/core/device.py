"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The port runs on the card unless the caller asks for the CPU.

    Raises when a CUDA device is asked for and none is present: a port
    entry point never falls back to the CPU on its own.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "litepi_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
