"""The port's optimisation ladder (``litepi_tpu_torch.bench.ladder``)
against the JAX package's (``litepi_tpu.bench.ladder``), mirroring
tests/test_ladder.py on the CPU at tiny shapes: the synthetic dataset and a
folder dataset load the same frames and ground truth; on the same variables
(tests/test_ladder.py's tiny detector with its class outputs x300, so that
candidate scores spread over (0.5, 1) and their order is stable) a staged
float32 level and a fused bf16 level give the same accuracy as JAX's; the
report, the LaTeX rows and the per-level pipeline cache behave as JAX's;
the progress figure is drawn, or skipped without matplotlib."""

import dataclasses
import os
import sys

import cv2
import numpy as np
import pytest

from litepi_tpu.bench import ladder as jax_ladder
from litepi_tpu.core.types import DetectorConfig, NMSConfig, PipelineConfig
from litepi_tpu_torch.bench import ladder as port_ladder
from tests.torch_port_helpers import (
    jax_init_vars,
    one_torch_thread,  # noqa: F401 (a fixture, used by pytestmark)
    port_config,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY_CFG = PipelineConfig(
    detector=DetectorConfig(name="tiny", base_channels=(32, 64, 128, 256, 512),
                            input_size=128),
    nms=NMSConfig(max_candidates=64, max_detections=8),
    num_classifier_classes=4,
    det_input_size=128,
    input_color="bgr",
)
LEVELS = [("Level 0", "staged batch 1 f32", 1, False, "float32"),
          ("Level 3", "fused batch 2", 2, True, "bfloat16")]
STATS = ("mAP50", "precision", "recall")


def _levels(module):
    return [module.LevelSpec(name, d, b, fused, dtype, max_detections=8)
            for name, d, b, fused, dtype in LEVELS]


@pytest.fixture(scope="module")
def variables():
    """The tiny pipeline's variables, its detector's kernels x1.3, biases 0,
    BatchNorm at its identity and class outputs x300."""
    det, clf = jax_init_vars(TINY_CFG, seed=0)

    def reset(node):
        for k, v in node.items():
            if isinstance(v, dict):
                reset(v)
            elif k == "kernel":
                node[k] = np.asarray(v) * np.float32(1.3)
            else:
                node[k] = np.ones_like(v) if k in ("scale", "var") else np.zeros_like(v)

    reset(det)
    for i in range(3):
        det["params"]["head"][f"cls{i}_out"]["kernel"] *= 300.0
    return det, clf


def _experiments(variables, monkeypatch, n_levels=2):
    """(JAX, port) experiments whose pipelines hold ``variables``."""
    from litepi_tpu.pipeline.two_stage import TwoStagePipeline as JaxPipeline
    from litepi_tpu_torch.pipeline import TwoStagePipeline

    det, clf = variables

    class JaxPipe(JaxPipeline):
        @classmethod
        def initialize(cls, cfg, dtype):
            return JaxPipeline(cfg, det, clf, dtype=dtype)

    class PortPipe(TwoStagePipeline):
        @classmethod
        def initialize(cls, cfg, dtype, device):
            return TwoStagePipeline.from_jax_vars(cfg, det, clf, dtype, device)

    monkeypatch.setattr(jax_ladder, "TwoStagePipeline", JaxPipe)
    monkeypatch.setattr(port_ladder, "TwoStagePipeline", PortPipe)
    return (jax_ladder.OptimizationExperiment(TINY_CFG, levels=_levels(jax_ladder)[:n_levels]),
            port_ladder.OptimizationExperiment(port_config(TINY_CFG),
                                               levels=_levels(port_ladder)[:n_levels],
                                               device="cpu"))


def test_synthetic_dataset_matches_jax():
    frames, gts = port_ladder.make_synthetic_dataset(5, (96, 128), seed=3)
    want_frames, want_gts = jax_ladder.make_synthetic_dataset(5, (96, 128), seed=3)
    np.testing.assert_array_equal(frames, want_frames)
    for (b, c), (wb, wc) in zip(gts, want_gts):
        np.testing.assert_array_equal(b, wb)
        np.testing.assert_array_equal(c, wc)


def test_ladder_runs_and_reports_as_jax(variables, monkeypatch):
    jexp, pexp = _experiments(variables, monkeypatch)
    for exp in (jexp, pexp):
        exp.use_synthetic_dataset(n=4)
    want = jexp.run_all_levels(warmup=0, iterations=1)
    got = pexp.run_all_levels(warmup=1, iterations=2)
    assert set(got) == set(want) == {"Level 0", "Level 3"}
    for name, s in got.items():
        assert s["fps"] > 0 and s["p95"] >= s["p50"] and s["batch"] == want[name]["batch"]
        for k in STATS:
            assert abs(s[k] - want[name][k]) <= 1e-6, (name, k, s[k], want[name][k])
    assert 0 < got["Level 0"]["recall"] < 1
    report = pexp.generate_comparison_report().splitlines()
    want_report = jexp.generate_comparison_report().splitlines()
    assert report[0] == want_report[0] and len(report) == len(want_report) == 3
    assert "speedup_vs_L0" in report[0] and "mAP50" in report[0]
    for line, want_line in zip(report[1:], want_report[1:]):
        # level, description and batch, then the accuracy columns, agree
        assert line.split(",")[:3] == want_line.split(",")[:3]
        assert line.split(",")[-4:-1] == want_line.split(",")[-4:-1]
    tex = pexp.generate_latex()
    assert "\\begin{tabular}" in tex and "Level 3" in tex and "mAP50" in tex


def test_ladder_loads_folder_dataset(variables, monkeypatch, tmp_path):
    img_dir, lbl_dir = tmp_path / "images", tmp_path / "labels"
    img_dir.mkdir()
    lbl_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        cv2.imwrite(str(img_dir / f"i{i}.jpg"), rng.integers(0, 255, (96, 128, 3), np.uint8))
        (lbl_dir / f"i{i}.txt").write_text("0 0.5 0.5 0.25 0.25\n")
    cv2.imwrite(str(img_dir / "odd.jpg"), np.zeros((64, 64, 3), np.uint8))  # dropped
    jexp, pexp = _experiments(variables, monkeypatch, n_levels=1)
    assert pexp.load_test_dataset(str(img_dir), str(lbl_dir)) == 3
    assert jexp.load_test_dataset(str(img_dir), str(lbl_dir)) == 3
    np.testing.assert_array_equal(pexp._frames, jexp._frames)
    for (b, c), (wb, wc) in zip(pexp._gts, jexp._gts):
        np.testing.assert_array_equal(b, wb)
        np.testing.assert_array_equal(c, wc)
    s = pexp.run_single_level(pexp.levels[0], warmup=0, iterations=1)
    assert s["fps"] > 0 and 0.0 <= s["mAP50"] <= 1.0


def test_pipeline_cache_shared_across_levels(variables, monkeypatch):
    _, pexp = _experiments(variables, monkeypatch)
    a = pexp._get_pipeline(pexp.levels[1])
    b = pexp._get_pipeline(dataclasses.replace(pexp.levels[1], batch=99))  # batch: not in the key
    assert a is b and a is not pexp._get_pipeline(pexp.levels[0])


def test_plot_optimization_progress(tmp_path, monkeypatch):
    exp = port_ladder.OptimizationExperiment(levels=port_ladder.LEVELS[:3], device="cpu")
    for i, spec in enumerate(exp.levels):
        exp.results[spec.name] = {
            "mean": 100.0 / (i + 1), "p50": 90.0, "p95": 110.0, "p99": 120.0,
            "fps": 10.0 * (i + 1), "batch": spec.batch, "mAP50": 0.5, "precision": 0.6,
            "recall": 0.4,
        }
    out = exp.plot_optimization_progress(str(tmp_path / "prog.png"))
    assert out is not None and os.path.getsize(out) > 0
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert exp.plot_optimization_progress(str(tmp_path / "none.png")) is None
    assert not (tmp_path / "none.png").exists()


def test_experiment_needs_a_card_by_default(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_ladder.OptimizationExperiment()
