"""The port stands alone: importing it (and chip_smoke.py) pulls in neither
JAX nor any module of the JAX package, and its entry points refuse to fall
back to the CPU on their own."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import importlib, pkgutil, sys
import litepi_tpu_torch, litepi_tpu_torch.pipeline
for m in pkgutil.walk_packages(litepi_tpu_torch.__path__, "litepi_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax") or m.startswith(("jax.", "flax.", "litepi_tpu."))
             or m == "litepi_tpu")
print("BAD", bad)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_no_jax_import_statements():
    pattern = re.compile(r"^\s*(import|from) (jax|flax|litepi_tpu)\b")
    files = [ROOT / "chip_smoke.py", *sorted((ROOT / "litepi_tpu_torch").rglob("*.py"))]
    hits = [
        f"{f.relative_to(ROOT)}:{i}"
        for f in files
        for i, line in enumerate(f.read_text().splitlines(), 1)
        if pattern.match(line)
    ]
    assert not hits


def test_entry_points_default_to_the_card():
    from litepi_tpu_torch.core import types
    from litepi_tpu_torch.pipeline import TwoStagePipeline

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = types.PipelineConfig(
        detector=types.DetectorConfig(
            name="tiny", base_channels=(32, 64, 128, 256, 512), input_size=160
        ),
        num_classifier_classes=10,
        det_input_size=160,
    )
    with pytest.raises(RuntimeError, match="CUDA"):
        TwoStagePipeline.initialize(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TwoStagePipeline.from_jax_vars(cfg, {"params": {}}, {"params": {}})


def test_streaming_runner_defaults_to_the_card():
    """A StreamingRunner runs on its pipeline's device; over a pipeline on
    the card (the default) it raises where there is none."""
    from litepi_tpu_torch.core import types
    from litepi_tpu_torch.pipeline import StreamingRunner, TwoStagePipeline

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = types.PipelineConfig(
        detector=types.DetectorConfig(
            name="tiny", base_channels=(32, 64, 128, 256, 512), input_size=160
        ),
        num_classifier_classes=10,
        det_input_size=160,
    )
    pipe = TwoStagePipeline.initialize(cfg, device="cpu")
    pipe.device = torch.device("cuda")  # as TwoStagePipeline.initialize(cfg) would set it
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingRunner(pipe, use_native_loader=False)


@pytest.mark.parametrize("app", ["train_detector", "train_classifier"])
def test_training_clis_default_to_the_card(app, tmp_path):
    """The training CLIs and their train states run on the card unless
    told ``--device cpu``; without one they raise before touching data."""
    import importlib

    from litepi_tpu_torch.core import types
    from litepi_tpu_torch.models import build_classifier
    from litepi_tpu_torch.train import create_classifier_train_state, create_detector_train_state

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    main = importlib.import_module(f"litepi_tpu_torch.apps.{app}").main
    data = ["--images", str(tmp_path), "--labels", str(tmp_path)] if app == "train_detector" \
        else ["--data", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(data + ["--output", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="CUDA"):
        create_detector_train_state(types.YOLO_PLUS_V2)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_classifier_train_state(build_classifier("shufflenetv2", 4))
