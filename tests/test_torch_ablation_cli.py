"""The port's ablation CLI (``litepi_tpu_torch.apps.ablation``) against the
JAX package's (``litepi_tpu.apps.ablation``), mirroring
tests/test_ablation_cli.py.

GFLOPs: the port counts with ``torch.utils.flop_counter.FlopCounterMode``
(the convolutions' 2 x multiply-adds, every tap of a padded window), the
JAX CLI with XLA's cost analysis of the whole forward (which also counts
elementwise work and treats padding its own way).  On the reference grid's
four variants at 640 the two agree within GFLOPS_REL_TOL: measured on the
CPU, the port's count is 0.15% (w0.5) to 0.87% (w1.0) above XLA's.
Parameter counts are equal.
"""

import csv
import os

import cv2
import numpy as np
import pytest

from litepi_tpu.apps import ablation as jax_ablation
from litepi_tpu_torch.apps import ablation as port_ablation
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GFLOPS_REL_TOL = 1e-2
REFERENCE_GRID = ["--widths", "0.5,0.75,1.0", "--depths", "0.33", "--extra", "0.75:0.67"]


def _rows(out):
    with open(os.path.join(out, "ablation_results.csv")) as f:
        return list(csv.DictReader(f))


def test_ablation_static_mode_matches_jax(tmp_path):
    """The reference grid at 640 through both CLIs: the same variants in the
    same order, equal parameter counts (w0.75 / d0.33 is the shipped
    yolo_plus_v2's 1.8M, README.md:14), GFLOPs within GFLOPS_REL_TOL."""
    outs = {}
    for name, main in (("jax", jax_ablation.main), ("port", port_ablation.main)):
        outs[name] = str(tmp_path / name)
        extra = ["--device", "cpu"] if name == "port" else []
        assert main([*REFERENCE_GRID, "--imgsz", "640", "--output", outs[name], *extra]) == 0
    got, want = _rows(outs["port"]), _rows(outs["jax"])
    assert [r["name"] for r in got] == [r["name"] for r in want] == [
        "ablation_w0.5_d0.33", "ablation_w0.75_d0.33", "ablation_w1_d0.33",
        "ablation_w0.75_d0.67"]
    for g, w in zip(got, want):
        for k in ("width_scale", "depth_scale", "params", "fps", "map50", "best_epoch"):
            assert g[k] == w[k], (g["name"], k)
        ratio = float(g["gflops"]) / float(w["gflops"])
        assert abs(ratio - 1) <= GFLOPS_REL_TOL, (g["name"], ratio)
    params = {r["name"]: int(r["params"]) for r in got}
    assert 1_700_000 < params["ablation_w0.75_d0.33"] < 1_900_000


def test_ablation_extra_combo_and_errors(tmp_path):
    for main in (jax_ablation.main, port_ablation.main):
        assert main(["--widths", "nope", "--output", str(tmp_path / "x")]) == 2
        assert main(["--train", "--output", str(tmp_path / "y")]) == 2


def test_ablation_bench_mode(tmp_path, capsys):
    """``--bench``: an FPS per variant (the host clock on the CPU), the
    other columns as in static mode."""
    out = str(tmp_path / "bench")
    assert port_ablation.main(["--widths", "0.5", "--depths", "0.33", "--extra", "",
                               "--imgsz", "64", "--bench", "--bench_batch", "2",
                               "--bench_iters", "2", "--output", out, "--device", "cpu"]) == 0
    (row,) = _rows(out)
    assert float(row["fps"]) > 0 and float(row["gflops"]) > 0 and row["map50"] == ""
    assert "fps" in capsys.readouterr().out


def test_ablation_train_mode(tmp_path):
    """``--train`` runs the port's detector CLI per variant (tiny run) and
    harvests its results.json into the map50 / best_epoch columns."""
    root = tmp_path / "data"
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(4):
        img = rng.integers(0, 120, (120, 160, 3), dtype=np.uint8)
        cv2.rectangle(img, (60, 40), (100, 80), (250, 250, 250), -1)
        cv2.imwrite(str(root / "images" / f"im{i}.jpg"), img)
        (root / "labels" / f"im{i}.txt").write_text("0 0.5 0.5 0.25 0.33\n")
    out = str(tmp_path / "abl")
    assert port_ablation.main([
        "--widths", "0.5", "--depths", "0.33", "--extra", "", "--imgsz", "64",
        "--output", out, "--train", "--images", str(root / "images"), "--labels",
        str(root / "labels"), "--epochs", "1", "--device", "cpu", "--train_args",
        "--batch 2 --steps_per_epoch 2 --max_gt 8 --imgsz 128"]) == 0
    (row,) = _rows(out)
    import json

    with open(os.path.join(out, row["name"], "results.json")) as f:
        res = json.load(f)
    assert row["map50"] == str(res["best_map50"]) != ""
    assert row["best_epoch"] == "1" == str(res["best_epoch"])


def test_default_device_needs_a_card(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_ablation.main(["--widths", "0.5", "--extra", "", "--output", str(tmp_path)])
