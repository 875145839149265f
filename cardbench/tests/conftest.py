"""Shared helpers of the benchmark's CPU tests: cells shrunk to a batch
that a CPU test run holds (the configurations keep their published
widths and the frames their sizes)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small_cell(name: str, batch: int = 4):
    from cardbench import spec

    cell = spec.resolve(name)
    cell.traffic = dict(cell.traffic, batch=batch, pool=2, warmup_batches=1, check_batches=2)
    return cell


@pytest.fixture
def cuda():
    """Skips a test that needs the card where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
