"""The port's detector training CLI (``litepi_tpu_torch/apps/
train_detector.py``) against the JAX package's, on the CPU with tiny
synthetic datasets (the tests/test_train_clis.py pattern).

The same argv (``--device cpu``) gives the same rc and a ``results.json``
with the same keys and the same variant, config and epoch counts; an
ablation scale on a zoo variant is refused with rc 2 by both; the port
refuses ``--data_parallel`` above 1 with rc 2 (ROADMAP M11).  A run cut
by ``--stop_after 1`` and continued with ``--resume`` ends with the
uninterrupted run's checkpoints, bit for bit, validation through the
port's ``PipelineEvaluator`` included (tolerance: none).
"""

import json
import os

import numpy as np
import pytest

from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def det_data(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("det")
    for split in ("train", "val"):
        (root / split / "images").mkdir(parents=True)
        (root / split / "labels").mkdir(parents=True)
        rng = np.random.default_rng(0)
        for i in range(4):
            img = rng.integers(0, 120, (120, 160, 3), dtype=np.uint8)
            cv2.rectangle(img, (60, 40), (100, 80), (250, 250, 250), -1)
            cv2.imwrite(str(root / split / "images" / f"im{i}.jpg"), img)
            (root / split / "labels" / f"im{i}.txt").write_text("0 0.5 0.5 0.25 0.33\n")
    return root


def _argv(data, out, *extra, val=False):
    argv = ["--images", str(data / "train" / "images"), "--labels", str(data / "train" / "labels"),
            "--imgsz", "64", "--batch", "2", "--steps_per_epoch", "1", "--max_gt", "8",
            "--output", str(out), "--device", "cpu", "--patience", "99", *extra]
    if val:
        argv += ["--val_images", str(data / "val" / "images"),
                 "--val_labels", str(data / "val" / "labels")]
    return argv


def test_same_argv_same_rc_and_results(det_data, tmp_path):
    from litepi_tpu.apps.train_detector import main as jax_main
    from litepi_tpu_torch.apps.train_detector import main as port_main

    argv = ["--epochs", "1"]
    assert jax_main(_argv(det_data, tmp_path / "jax", *argv)) == 0
    assert port_main(_argv(det_data, tmp_path / "port", *argv)) == 0
    want = json.loads((tmp_path / "jax" / "results.json").read_text())
    got = json.loads((tmp_path / "port" / "results.json").read_text())
    assert sorted(got) == sorted(want)
    for k in ("variant", "config", "best_epoch", "epochs_run"):
        assert got[k] == want[k], k
    for d in ("best", "last", "resume"):
        assert os.path.isdir(tmp_path / "port" / d)
    bad = ["--epochs", "1", "--variant", "yolov11n", "--width_scale", "0.5"]
    assert jax_main(_argv(det_data, tmp_path / "jax2", *bad)) == 2
    assert port_main(_argv(det_data, tmp_path / "port2", *bad)) == 2


def test_data_parallel_waits_for_m11(det_data, tmp_path, capsys):
    from litepi_tpu_torch.apps.train_detector import main

    assert main(_argv(det_data, tmp_path, "--epochs", "1", "--data_parallel", "2")) == 2
    assert "M11" in capsys.readouterr().err


def test_resume_equals_uninterrupted(det_data, tmp_path):
    from litepi_tpu_torch.apps.train_detector import main
    from litepi_tpu_torch.weights.checkpoint import load_checkpoint
    from tests.torch_port_helpers import assert_tree_equal

    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    assert main(_argv(det_data, straight, "--epochs", "2", val=True)) == 0
    assert main(_argv(det_data, resumed, "--epochs", "2", "--stop_after", "1", val=True)) == 0
    assert os.path.isdir(resumed / "resume")
    assert main(_argv(det_data, resumed, "--epochs", "2", "--resume", val=True)) == 0
    for d in ("last", "best"):
        assert_tree_equal(load_checkpoint(str(resumed / d)), load_checkpoint(str(straight / d)))
    a = json.loads((straight / "results.json").read_text())
    b = json.loads((resumed / "results.json").read_text())
    assert a == b and a["best_map50"] is not None and a["epochs_run"] == 2
    tree = load_checkpoint(str(straight / "last"))
    assert sorted(tree) == ["batch_stats", "params"] and "backbone" in tree["params"]


@pytest.mark.parametrize("variant", ["yolov11n", "yolov5n"])
def test_zoo_variants_train_and_validate(det_data, tmp_path, variant):
    """The injected zoo detectors train under the same TAL loss and validate
    through their own model; ``last`` loads strictly into that model."""
    from litepi_tpu_torch.apps.train_detector import custom_detector, main
    from litepi_tpu_torch.weights.checkpoint import load_checkpoint
    from litepi_tpu_torch.weights.jax_bridge import jax_to_state_dict

    assert main(_argv(det_data, tmp_path, "--epochs", "1", "--variant", variant, val=True)) == 0
    results = json.loads((tmp_path / "results.json").read_text())
    assert results["variant"] == variant and results["best_map50"] is not None
    custom_detector(variant, 1).load_state_dict(
        jax_to_state_dict(load_checkpoint(str(tmp_path / "last"))))
