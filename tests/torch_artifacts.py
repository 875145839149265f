"""Deployed-artifact writers for the port's tests and ``chip_smoke.py``,
with torch only (importing this module pulls in no JAX).

:func:`save_ultralytics_container` writes what an Ultralytics training run
saves (``best.pt``): a pickle of ``{"model": <DetectionModel>.half(), ...}``
whose model class claims to live in ``ultralytics.nn.tasks``.  The fake
package exists only while the file is written, so a later load succeeds
only through a stub unpickler (``weights/torch_import.py``), as a load
without the ultralytics package would.
"""

from __future__ import annotations

import copy
import sys
import types

import torch


def save_ultralytics_container(model: torch.nn.Module, path: str) -> None:
    """Pickle ``{"model": model.half(), "ema": None, ...}`` (a half copy;
    ``model`` is left as it is) with the model's class renamed
    ``ultralytics.nn.tasks.DetectionModel``."""
    cls = type("DetectionModel", (type(model),), {"__module__": "ultralytics.nn.tasks"})
    fake = cls.__new__(cls)
    fake.__dict__.update(copy.deepcopy(model).__dict__)
    mods = {name: types.ModuleType(name)
            for name in ("ultralytics", "ultralytics.nn", "ultralytics.nn.tasks")}
    mods["ultralytics.nn.tasks"].DetectionModel = cls
    sys.modules.update(mods)
    try:
        torch.save({"model": fake.half(), "ema": None, "epoch": 7, "date": "x"}, path)
    finally:
        for name in mods:
            del sys.modules[name]
