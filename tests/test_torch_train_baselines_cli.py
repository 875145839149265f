"""The port's baseline training CLI (``litepi_tpu_torch.apps.
train_baselines``) and the detector bench's ``--checkpoint`` on the CPU, at
tiny sizes: a Faster R-CNN run (input 64, ``pre_nms_topk`` 64,
``post_nms_topk`` 16, the JAX CLI's tiny-run knobs) writes ``best`` /
``last`` checkpoints and ``results.json`` with the JAX CLI's keys, and
``python -m litepi_tpu_torch.bench.detector_bench --checkpoint`` loads
them and prints a row with the JAX bench's columns; the refusals exit with
rc 2 and one ``error:`` line (an ssd300 ``--imgsz`` other than 300, as the
JAX CLI; ``--data_parallel 2`` under ``--device cuda`` without two visible
cards); ``--data_parallel 2 --device cpu`` (gloo ranks) takes the
``--data_parallel 1`` run's SSD300 step (the loss bit-equal, the weights
within one bf16 ulp; Faster R-CNN's 1-vs-2-rank step is held in float64
in tests/test_torch_baselines_dp.py); ``--pre_nms_topk 2000`` (torchvision's
training default, above 1,024 candidates) runs; the default ``--device``
raises without a card."""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from litepi_tpu_torch.apps import train_baselines
from litepi_tpu_torch.bench import detector_bench
from litepi_tpu_torch.weights.checkpoint import load_checkpoint
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("baselines")
    rng = np.random.default_rng(0)
    d = {}
    for split, n in (("train", 4), ("val", 2)):
        img_dir, lbl_dir = root / split / "images", root / split / "labels"
        os.makedirs(img_dir)
        os.makedirs(lbl_dir)
        for i in range(n):
            h, w = 72, 96
            img = rng.integers(0, 120, (h, w, 3), dtype=np.uint8)
            bw, bh = (int(v) for v in rng.integers(12, 30, 2))
            x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            img[y:y + bh, x:x + bw] = 230
            cv2.imwrite(str(img_dir / f"f{i}.jpg"), img)
            (lbl_dir / f"f{i}.txt").write_text(
                f"0 {(x + bw / 2) / w:.6f} {(y + bh / 2) / h:.6f} {bw / w:.6f} {bh / h:.6f}\n")
        d[split] = (str(img_dir), str(lbl_dir))
    d["root"] = root
    return d


def _argv(data, out, *extra):
    return ["--images", data["train"][0], "--labels", data["train"][1], "--val_images",
            data["val"][0], "--val_labels", data["val"][1], "--output", str(out), "--epochs",
            "2", "--batch", "2", "--steps_per_epoch", "1", *extra]


TINY = ["--arch", "faster_rcnn", "--imgsz", "64", "--pre_nms_topk", "64", "--post_nms_topk",
        "16", "--device", "cpu"]


def test_tiny_faster_rcnn_run_feeds_the_bench(data, tmp_path, capsys):
    out = tmp_path / "frcnn"
    assert train_baselines.main(_argv(data, out, *TINY)) == 0
    text = capsys.readouterr().out
    assert text.count("epoch ") >= 2 and "validation" in text
    res = json.loads((out / "results.json").read_text())
    assert sorted(res) == ["arch", "best_epoch", "best_score", "epochs_run"]
    assert res["arch"] == "faster_rcnn" and res["epochs_run"] == 2
    tree = load_checkpoint(str(out / "last"))
    assert {"backbone", "fpn", "rpn", "box_head"} <= set(tree["params"])
    assert "layer1_0" in tree["batch_stats"]["backbone"]
    assert (out / "best").is_dir()
    assert detector_bench.main(["--variants", "faster_rcnn", "--checkpoint", str(out / "last"),
                                "--images", data["val"][0], "--labels", data["val"][1],
                                "--input_size", "64", "--iters", "1", "--warmup", "1",
                                "--device", "cpu"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("model", "backend", "batch", "pre_ms", "infer_ms", "post_ms", "total_ms", "fps",
                "num_images", "mAP50", "mAP50_95", "precision", "recall"):
        assert key in row, key
    assert row["backend"] == "cpu" and row["num_images"] == 2


@pytest.mark.parametrize("case,extra", [
    ("ssd300 imgsz", ["--arch", "ssd300", "--imgsz", "320", "--device", "cpu"]),
    ("data_parallel", ["--arch", "faster_rcnn", "--data_parallel", "2", "--device", "cuda"]),
])
def test_rc2_paths(data, tmp_path, capsys, case, extra):
    rc = train_baselines.main(_argv(data, tmp_path / "out", *extra))
    err = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("error")]
    assert rc == 2 and len(err) == 1, err
    key = {"ssd300 imgsz": "300", "data_parallel": "visible"}
    assert key[case] in err[0]


def test_data_parallel_2_equals_1(data, tmp_path, monkeypatch):
    """One step of SSD300 in the CLI's bf16 at ``--data_parallel 2 --device
    cpu`` (one row each of the global batch of 2): its loss (``best_score``,
    the negated loss without a validation set) is the ``--data_parallel 1``
    run's, bit for bit, and after the update every leaf of the weights is
    within one bf16 ulp of its largest magnitude of the 1-rank run's (the
    ranks sum the gradients in another order); only rank 0 writes."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks' torch threads
    res, leaves = {}, {}
    for n in (1, 2):
        out = tmp_path / f"dp{n}"
        argv = ["--images", data["train"][0], "--labels", data["train"][1], "--output",
                str(out), "--epochs", "1", "--batch", "2", "--steps_per_epoch", "1", "--arch",
                "ssd300", "--device", "cpu", "--data_parallel", str(n)]
        assert train_baselines.main(argv) == 0
        res[n] = json.loads((out / "results.json").read_text())
        leaves[n] = {}

        def walk(t, prefix, n=n):
            for k, v in t.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}/", n)
                else:
                    leaves[n][prefix + k] = np.asarray(v, np.float64)

        walk(load_checkpoint(str(out / "last")), "")
        assert sorted(os.listdir(out)) == ["best", "last", "results.json"]
    assert res[1]["epochs_run"] == res[2]["epochs_run"] == 1
    assert res[2]["best_score"] == res[1]["best_score"], res
    assert sorted(leaves[2]) == sorted(leaves[1])
    for name, want in leaves[1].items():
        got = leaves[2][name]
        _, exp = np.frexp(max(np.abs(want).max(), np.abs(got).max()))
        assert np.abs(got - want).max() <= np.ldexp(1.0, exp - 8), name  # bf16: 8 bits


def test_pre_nms_topk_2000_runs(data, tmp_path, capsys):
    """``--pre_nms_topk 2000``, more than 1,024 candidates (the refusal it
    replaces is gone with the NMS kernel's bound): at input 128 the RPN has
    4,092 anchors, so its NMS takes K = 2,000, through one step and its
    validation."""
    out = tmp_path / "frcnn2000"
    argv = _argv(data, out, "--arch", "faster_rcnn", "--imgsz", "128", "--pre_nms_topk", "2000",
                 "--post_nms_topk", "16", "--device", "cpu")
    argv[argv.index("--epochs") + 1] = "1"
    assert train_baselines.main(argv) == 0
    assert "validation" in capsys.readouterr().out
    res = json.loads((out / "results.json").read_text())
    assert res["epochs_run"] == 1 and np.isfinite(res["best_score"])


def test_default_device_needs_a_card(data, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_baselines.main(_argv(data, tmp_path / "out", "--arch", "ssd300"))


def test_bench_checkpoint_refusals(tmp_path, capsys):
    assert detector_bench.main(["--variants", "ssd300", "faster_rcnn", "--checkpoint",
                                str(tmp_path), "--device", "cpu"]) == 2
    assert detector_bench.main(["--variants", "ssd300", "--checkpoint", str(tmp_path),
                                "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "exactly one variant" in err and "--checkpoint" in err


def test_bench_entry_points_default_to_the_card(monkeypatch):
    from litepi_tpu_torch.bench import classifier_bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        detector_bench.make_harness("ssd300")
    with pytest.raises(RuntimeError, match="CUDA"):
        classifier_bench.predict_topk("shufflenetv2", {}, np.zeros((8, 8, 3), np.float32), 10)
