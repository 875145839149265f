"""Per-stage timing and pipeline metrics.

The reference wraps every pipeline stage in wall-clock timers and collects
them into a ``PipelineMetrics`` dataclass (reference: e2e.py:34-62, populated
at :451-506), plus psutil CPU / RSS and SoC temperature probes (:509-516).

On a CUDA card work is issued asynchronously, so a stage timer must wait for
the stage's outputs (``torch.cuda.synchronize`` on their devices) to see the
card's real latency.  ``StageTimer`` does that, and ``PipelineMetrics`` keeps
the reference's field names so CSV schemas stay compatible.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Set

import numpy as np
import torch


@dataclasses.dataclass
class PipelineMetrics:
    """Per-frame (or per-batch) stage timings, in milliseconds.

    Field names follow the reference dataclass (e2e.py:34-62) so downstream
    CSV/reporting code is drop-in compatible.
    """

    t_detection: float = 0.0
    t_roi_extract: float = 0.0
    t_classification: float = 0.0
    t_postprocess: float = 0.0
    t_total: float = 0.0
    fps: float = 0.0
    num_detections: int = 0
    cpu_percent: float = 0.0
    memory_mb: float = 0.0
    temperature_c: Optional[float] = None

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _cuda_devices(tree: Any, found: Set[torch.device]) -> None:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)


class StageTimer:
    """Wall-clock stage timer that waits for the card.

    Usage::

        timer = StageTimer()
        with timer.stage("detection"):
            out = detect_fn(x)
            timer.sync(out)          # wait for the card's outputs inside the stage
        ms = timer.times_ms["detection"]
    """

    def __init__(self) -> None:
        self.times_ms: Dict[str, float] = {}

    class _Ctx:
        def __init__(self, timer: "StageTimer", name: str) -> None:
            self._timer = timer
            self._name = name

        def __enter__(self) -> "StageTimer._Ctx":
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc) -> None:
            dt = (time.perf_counter() - self._t0) * 1e3
            self._timer.times_ms[self._name] = (
                self._timer.times_ms.get(self._name, 0.0) + dt
            )

    def stage(self, name: str) -> "StageTimer._Ctx":
        return StageTimer._Ctx(self, name)

    @staticmethod
    def sync(tree: Any) -> Any:
        """Wait until every CUDA tensor in ``tree`` (tensors, dicts, lists,
        tuples) is computed: one ``torch.cuda.synchronize`` per CUDA device
        found.  CPU tensors need no wait.  Returns ``tree``."""
        devices: Set[torch.device] = set()
        _cuda_devices(tree, devices)
        for dev in devices:
            torch.cuda.synchronize(dev)
        return tree


def percentile_summary(latencies_ms: List[float]) -> Dict[str, float]:
    """P50/P95/P99 latency summary, as the reference prints per optimisation
    level (reference: runner.py:885-887)."""
    arr = np.asarray(latencies_ms, dtype=np.float64)
    if arr.size == 0:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0}
    return {
        "p50": float(np.percentile(arr, 50)),
        "p95": float(np.percentile(arr, 95)),
        "p99": float(np.percentile(arr, 99)),
        "mean": float(arr.mean()),
    }


def read_host_counters() -> Dict[str, float]:
    """CPU%, RSS MB and (when exposed) SoC temperature, mirroring the
    reference's psutil + /sys/class/thermal probes (e2e.py:509-516).  Without
    psutil the CPU and memory keys are absent."""
    out: Dict[str, float] = {}
    try:
        import psutil
    except ImportError:
        psutil = None
    if psutil is not None:
        out["cpu_percent"] = psutil.cpu_percent(interval=None)
        out["memory_mb"] = psutil.Process().memory_info().rss / (1024 * 1024)
    try:
        with open("/sys/class/thermal/thermal_zone0/temp") as f:
            out["temperature_c"] = int(f.read().strip()) / 1000.0
    except (OSError, ValueError):
        pass
    return out
