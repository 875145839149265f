"""Hardware / environment report of the PyTorch port (the reference dumps
its benchmark environment, evaluation-tsr.ipynb cell 20: CPU model, RAM,
library versions).  In the port's terms: torch, CUDA and cuDNN versions,
the card's name, count and memory, and its power limit where
``nvidia-smi`` answers.

    python -m litepi_tpu_torch.bench.envinfo
"""

from __future__ import annotations

import json
import platform
import subprocess
import sys
from typing import Dict, List, Optional


def _power_limits() -> Optional[List[str]]:
    """``nvidia-smi``'s name and power limit of each card, or None where it
    does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def environment_report() -> Dict[str, object]:
    import torch

    out: Dict[str, object] = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "processor": platform.processor() or "unknown",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cudnn": torch.backends.cudnn.version(),
        "cuda_available": torch.cuda.is_available(),
        "device_count": torch.cuda.device_count(),
        "devices": [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())],
        "device_memory_gb": [
            round(torch.cuda.get_device_properties(i).total_memory / 2**30, 1)
            for i in range(torch.cuda.device_count())
        ],
    }
    limits = _power_limits() if out["device_count"] else None
    if limits is not None:
        out["nvidia_smi"] = limits
    try:
        import psutil

        out["ram_gb"] = round(psutil.virtual_memory().total / 2**30, 1)
        out["cpus"] = psutil.cpu_count()
    except ImportError:  # pragma: no cover
        pass
    from litepi_tpu_torch.data import native_loader

    out["native_loader"] = native_loader.available()
    return out


def main() -> int:
    print(json.dumps(environment_report(), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
