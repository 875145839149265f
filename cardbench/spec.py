"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
the harness finds

* the configuration at ``configs/<config>.json``,
* the traffic mix at ``traffic/<traffic>.json`` (parameters that the one
  generator, ``cardbench/traffic.py``, reads),
* the limits of the comparison that decides ``correct`` at
  ``limits/<cell>.json``,
* each per-layer metric's reader at ``metrics/<metric>.py``,

all under this package's directory.  Adding a cell, a configuration, a mix
or a metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def resolve(name: str, bench: Optional[dict] = None, here: Path = HERE) -> Cell:
    """The cell ``name`` with its configuration, traffic, limits and the
    metrics it reports.  Raises ``KeyError`` for an unknown cell and
    ``FileNotFoundError`` for a missing file."""
    bench = bench if bench is not None else load_benchmark(here.parent)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    return from_files(name, w["config"], w["traffic"], int(w["chips"]), e2e, per_layer, here)


def from_files(name: str, config: str, traffic: str, chips: int, end_to_end: List[dict],
               per_layer: List[dict], here: Path = HERE) -> Cell:
    """A cell from its files: ``configs/<config>.json``,
    ``traffic/<traffic>.json``, ``limits/<name>.json`` and a reader for
    each per-layer metric."""
    for m in per_layer:
        if not (here / "metrics" / f"{m['name']}.py").is_file():
            raise FileNotFoundError(f"metric {m['name']!r} has no reader metrics/{m['name']}.py")
    return Cell(name, chips,
                json.loads((here / "configs" / f"{config}.json").read_text()),
                json.loads((here / "traffic" / f"{traffic}.json").read_text()),
                json.loads((here / "limits" / f"{name}.json").read_text()),
                end_to_end, per_layer)


def reader(metric: str, here: Path = HERE) -> Callable[[dict], Optional[float]]:
    """The ``read(run)`` function of ``metrics/<metric>.py`` (loaded by
    path: a metric's name may hold dots)."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"cardbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
