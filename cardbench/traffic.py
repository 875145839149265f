"""The one traffic generator: frames from a traffic mix's parameters
(``traffic/<mix>.json``) and the run's seed.

Parameters of a mix (closed loop: the next batch goes as soon as fewer
than ``in_flight`` are outstanding):

``batch``
    frames per call.
``height``, ``width``
    frame size, uint8 BGR, made and kept on the card (frames that arrive
    by hardware decode).
``pool``
    distinct batches, served round robin.
``in_flight``
    the most batches outstanding at once.
``warmup_batches``, ``check_batches``
    calls before the window (twice: warm-up, then pacing); batches whose
    outputs the comparison judges.

Frames are a smooth random field plus fine noise, made on the device in
chunks of :data:`CHUNK` frames, each chunk from a generator of its own, so
that any rows of any batch are the same frames whichever call makes them.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F


def seed_of(seed: int, salt: int) -> int:
    """A generator seed for ``salt`` under the run's seed (any size)."""
    return (int(seed) * 1_000_003 + salt * 7_919) % (2 ** 63)

CHUNK = 16
COARSE = 40  # pixels per cell of the smooth field
NOISE = 24.0  # half-width of the uniform fine noise, in 0-255 steps


def make_frames(seed: int, first: int, count: int, h: int, w: int, device) -> torch.Tensor:
    """Frames ``first .. first + count`` of the run's frame sequence:
    (count, h, w, 3) uint8 on ``device``."""
    out = torch.empty((count, h, w, 3), dtype=torch.uint8, device=device)
    i = first
    while i < first + count:
        chunk = i // CHUNK
        lo, hi = max(first, chunk * CHUNK), min(first + count, (chunk + 1) * CHUNK)
        gen = torch.Generator(device=device).manual_seed(seed_of(seed, 100 + chunk))
        coarse = torch.rand((CHUNK, 3, h // COARSE + 2, w // COARSE + 2), generator=gen,
                            device=device) * 255.0
        field = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
        field += (torch.rand(field.shape, generator=gen, device=device) * 2.0 - 1.0) * NOISE
        frames = field.clamp_(0.0, 255.0).round_().to(torch.uint8).permute(0, 2, 3, 1)
        out[lo - first:hi - first] = frames[lo - chunk * CHUNK:hi - chunk * CHUNK]
        i = hi
    return out


def device_pool(traffic: dict, seed: int, device) -> List[torch.Tensor]:
    """The pool: ``pool`` batches of ``batch`` frames on ``device``."""
    b, h, w = traffic["batch"], traffic["height"], traffic["width"]
    return [make_frames(seed, p * b, b, h, w, device) for p in range(traffic["pool"])]
