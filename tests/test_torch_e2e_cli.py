"""The port's e2e CLI (``litepi_tpu_torch.apps.e2e``) against the JAX
package's (``litepi_tpu.apps.e2e``), both ``--device cpu``, on the same
synthetic JPEG dataset and the same deployed artifacts: a yolo_plus_v2 NCNN
pair (the JAX emitter's, from seeded variables with the class outputs
scaled so that candidate scores spread over (0.5, 1)) and a torchvision-keyed
ShuffleNetV2 ``.pth`` (its Dense scaled likewise).

Both thresholds sit in gaps of the candidate scores (every score over them
further than 1e-5 from them and from each other, checked on the port's
scores), and the labels come from the port's own detections, jittered, so
the metric rows are neither 0 nor 1.  The metric columns of
``comparison_summary.csv`` (P/R/F1/mAP@0.5/mAP@0.5:0.95) must be equal,
fps left out; the per-class results CSVs match within
tests/test_torch_evaluator.py's tolerances (floats 1e-6, counts exact).
The rc-2 paths give rc 2 and the same key words on stderr on both sides
(a conflicting ``--detector_variant``, a classifier graph with another
class count, ``--detector_param`` without ``--detector_bin``); an orbax
directory is the port's own rc-2 path, and ``--roi_impl windowed`` runs on
both sides with the same metric columns.  Also:
the port's checkpoint round trip, through the CLI too, and the
``--matmul_precision`` mapping.
"""

import csv
import os

import cv2
import numpy as np
import pytest
import torch

from litepi_tpu.core.types import YOLO_PLUS_V2
from litepi_tpu.models import YoloLitePi
from litepi_tpu.models import build_classifier as jax_build_classifier
from litepi_tpu.weights import ncnn_export
from litepi_tpu_torch.apps import e2e as port_e2e
from tests.test_torch_evaluator import separated_conf
from tests.torch_port_helpers import (
    assert_tree_equal,
    one_torch_thread,  # noqa: F401 (a fixture, used by pytestmark)
    peaked_frames,
    random_jax_vars,
)
from tests.torch_refs import ShuffleNetV2T

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NUM_CLASSES = 10
SIZES = [(200, 320), (240, 320), (320, 200), (200, 320), (300, 260)]
COMMON = ["--num_classes", str(NUM_CLASSES), "--det_input_size", "160", "--batch_size", "2",
          "--max_det", "8", "--max_candidates", "64", "--num_samples", "4", "--device", "cpu",
          "--warmup", "1"]
METRICS = ("mean_precision", "mean_recall", "mean_f1", "mAP50", "mAP50-95")


def _detector_vars():
    """yolo_plus_v2 variables with kernels N(0, 1.3^2 / fan_in), biases 0
    and BatchNorm at its identity (random statistics wash the input out of
    this deep net's scores), the class outputs x300 and the DFL bins given
    a falling bias, so that candidate scores spread over (0.5, 1) and boxes
    are small and varied."""
    det = random_jax_vars(YoloLitePi(YOLO_PLUS_V2), seed=21)

    def reset(node, path=()):
        for k, v in node.items():
            if isinstance(v, dict):
                reset(v, path + (k,))
            elif k == "kernel":
                node[k] = v * np.float32(1.3)
            else:  # biases, BatchNorm scales and statistics
                one = k in ("scale", "var")
                node[k] = np.ones_like(v) if one else np.zeros_like(v)

    reset(det)
    head = det["params"]["head"]
    for i in range(3):
        head[f"cls{i}_out"]["kernel"] *= 300.0
        head[f"reg{i}_out"]["kernel"] *= 30.0
        head[f"reg{i}_out"]["bias"] = np.tile(-0.7 * np.arange(16, dtype=np.float32), 4)
    return det


def _write_labels(labels, paths, results, rng):
    for i, (p, res) in enumerate(zip(paths, results)):
        if i == len(paths) - 1:
            continue  # no label file: a negative image
        h, w = cv2.imread(p).shape[:2]
        rows = []
        for b, c in zip(res["boxes"], res["labels"]):
            if rng.uniform() < 0.2:
                continue
            b = b + rng.normal(0, 3.0, 4)
            c = int(c) if rng.uniform() < 0.6 else int(rng.integers(NUM_CLASSES))
            rows.append(f"{c} {(b[0] + b[2]) / 2 / w:.6f} {(b[1] + b[3]) / 2 / h:.6f} "
                        f"{(b[2] - b[0]) / w:.6f} {(b[3] - b[1]) / h:.6f}\n")
        stem = os.path.splitext(os.path.basename(p))[0]
        with open(os.path.join(labels, stem + ".txt"), "w") as f:
            f.writelines(rows)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Artifacts, frames, labels and the two thresholds."""
    from litepi_tpu_torch.core import types as T
    from litepi_tpu_torch.pipeline import PipelineEvaluator, TwoStagePipeline
    from litepi_tpu_torch.weights.ncnn_import import convert_detector_ncnn
    from litepi_tpu_torch.weights.torch_import import (
        convert_classifier_state_dict,
        load_torch_state_dict,
    )

    root = tmp_path_factory.mktemp("cli")
    d = {k: str(root / k) for k in ("images", "labels")}
    for k in ("images", "labels"):
        os.makedirs(d[k])
    paths = []
    for i, (h, w) in enumerate(SIZES):
        paths.append(os.path.join(d["images"], f"img{i}.jpg"))
        cv2.imwrite(paths[-1], peaked_frames(seed=70 + i, batch=1, h=h, w=w)[0])
    d["param"], d["bin"] = str(root / "det.param"), str(root / "det.bin")
    ncnn_export.export_detector_ncnn(_detector_vars(), YOLO_PLUS_V2, d["param"], d["bin"])
    torch.manual_seed(22)
    clf = ShuffleNetV2T(NUM_CLASSES)  # BatchNorm at its identity: the labels vary
    with torch.no_grad():
        clf.fc.weight *= 300.0
    d["pth"] = str(root / "shufflenetv2.pth")
    torch.save(clf.state_dict(), d["pth"])
    # a classifier NCNN pair with NUM_CLASSES classes, for the class check
    d["cls_param"] = str(root / "cls.param")
    ncnn_export.export_classifier_ncnn(
        "shufflenetv2", random_jax_vars(jax_build_classifier("shufflenetv2", NUM_CLASSES), 24),
        NUM_CLASSES, d["cls_param"], str(root / "cls.bin"))

    # thresholds in gaps of the port's candidate scores, labels from its
    # detections (the CLI's sampling picks the same 4 frames)
    d["det_vars"] = convert_detector_ncnn(d["param"], d["bin"])[0]
    d["cls_vars"] = convert_classifier_state_dict("shufflenetv2", load_torch_state_dict(d["pth"]))
    cfg = T.PipelineConfig(
        detector=T.DetectorConfig(input_size=160),
        nms=T.NMSConfig(max_candidates=64, max_detections=8),
        num_classifier_classes=NUM_CLASSES, det_input_size=160, batch_size=2,
        input_color="bgr")
    ev = PipelineEvaluator(TwoStagePipeline.from_jax_vars(cfg, d["det_vars"], d["cls_vars"],
                                                          device="cpu"))
    images = [cv2.imread(p) for p in paths]
    scores = ev.pipe.detect_candidates(ev._to_unit(ev._letterbox_batch(images)[0]))[1].numpy()
    d["yolo_conf"] = separated_conf(scores, 3, 60)
    d["bench_conf"] = separated_conf(scores[:, :64], 1, 8)
    results = ev.run_images(images, d["yolo_conf"], eval_budget=True)
    _write_labels(d["labels"], paths, results, np.random.default_rng(25))
    return d


def _args(data, out, *extra):
    return ["--input", data["images"], "--labels", data["labels"], "--output", str(out),
            "--yolo_conf", repr(data["yolo_conf"]), "--benchmark_conf", repr(data["bench_conf"]),
            *COMMON, *extra]


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _run_both(data, tmp_path, *extra):
    from litepi_tpu.apps import e2e as jax_e2e

    outs = {}
    for name, main in (("jax", jax_e2e.main), ("port", port_e2e.main)):
        outs[name] = tmp_path / name
        assert main(_args(data, outs[name], *extra)) == 0
    return outs


def _assert_same_outputs(got_dir, want_dir, combo):
    got = _rows(got_dir / "comparison_summary.csv")
    want = _rows(want_dir / "comparison_summary.csv")
    assert len(got) == len(want) == 1
    for k in ("model_combination", "detector", "classifier", "num_test_images", *METRICS):
        assert got[0][k] == want[0][k], (k, got[0][k], want[0][k])
    assert 0 < float(want[0]["mAP50"]) < 1 and 0 < float(want[0]["mean_f1"]) < 1
    assert float(got[0]["fps"]) > 0
    got = _rows(got_dir / combo / f"{combo}_results.csv")
    want = _rows(want_dir / combo / f"{combo}_results.csv")
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g["class"] == w["class"]
        for k in ("tp", "fp", "fn"):
            assert g[k] == w[k], (w["class"], k)
        for k in ("precision", "recall", "f1"):
            assert abs(float(g[k]) - float(w[k])) <= 1e-6, (w["class"], k)
    for name in (f"{combo}_test_files.txt",):
        assert (got_dir / combo / name).read_text() == (want_dir / combo / name).read_text()


def test_cli_matches_jax_on_ncnn_and_pth(data, tmp_path):
    """The deployed pair: the variant inferred from the NCNN topology."""
    outs = _run_both(data, tmp_path, "--detector_param", data["param"], "--detector_bin",
                     data["bin"], "--classifier", data["pth"], "--save_viz")
    combo = "yolo_plus_v2+shufflenetv2"
    _assert_same_outputs(outs["port"], outs["jax"], combo)
    assert len(os.listdir(outs["port"] / combo / "viz")) == 4


def _rc2(main, argv, capsys):
    rc = main(argv)
    err = capsys.readouterr().err
    return rc, err


# (extra arguments, key words both CLIs print on stderr with rc 2)
RC2_BOTH = {
    "conflicting_variant": (["--detector_param", "{param}", "--detector_bin", "{bin}",
                             "--detector_variant", "yolov8n"],
                            ["--detector_variant yolov8n", "conflicts", "yolo_plus_v2"]),
    "class_mismatch": (["--detector_param", "{param}", "--detector_bin", "{bin}",
                        "--classifier", "{cls_param}", "--num_classes", "5"],
                       ["--classifier graph has 10 classes", "--num_classes says 5"]),
    "missing_detector_bin": (["--detector_param", "{param}"],
                             ["--detector_param needs --detector_bin"]),
}


@pytest.mark.parametrize("case", sorted(RC2_BOTH))
def test_rc2_paths_match_jax(data, tmp_path, capsys, case):
    from litepi_tpu.apps import e2e as jax_e2e

    extra, words = RC2_BOTH[case]
    extra = [a.format(**data) for a in extra]
    for main in (jax_e2e.main, port_e2e.main):
        rc, err = _rc2(main, _args(data, tmp_path / "out", *extra), capsys)
        assert rc == 2, err
        for w in words:
            assert w in err, (main.__module__, w, err)
    assert not (tmp_path / "out").exists()


def test_rc2_orbax_directory(data, tmp_path, capsys):
    """An orbax checkpoint (the JAX package's format) is refused, with one
    line on stderr, as detector and as classifier."""
    from litepi_tpu.weights.checkpoint import save_checkpoint as orbax_save

    orb = str(tmp_path / "orbax")
    orbax_save(orb, data["cls_vars"])
    for flag in ("--detector", "--classifier"):
        rc, err = _rc2(port_e2e.main, _args(data, tmp_path / "out", flag, orb), capsys)
        lines = [ln for ln in err.splitlines() if ln.startswith("error")]
        assert rc == 2 and len(lines) == 1 and "orbax" in lines[0], err
        assert flag in lines[0]


def test_rc2_roi_impl_windowed(data, tmp_path):
    """``--roi_impl windowed`` is ported now (the name is the test's
    history): both CLIs with it write the same metric columns."""
    outs = _run_both(data, tmp_path, "--detector_param", data["param"], "--detector_bin",
                     data["bin"], "--classifier", data["pth"], "--roi_impl", "windowed")
    _assert_same_outputs(outs["port"], outs["jax"], "yolo_plus_v2+shufflenetv2")


def test_checkpoint_round_trip(data, tmp_path):
    """``save_checkpoint`` / ``load_checkpoint`` give back the tree, and
    the CLI on those checkpoints writes the NCNN + .pth run's metrics."""
    from litepi_tpu_torch.weights.checkpoint import load_checkpoint, save_checkpoint

    det, clf = str(tmp_path / "det_ckpt"), str(tmp_path / "cls_ckpt")
    save_checkpoint(det, data["det_vars"])
    save_checkpoint(clf, data["cls_vars"])
    assert_tree_equal(load_checkpoint(det), data["det_vars"])
    assert_tree_equal(load_checkpoint(clf), data["cls_vars"])
    save_checkpoint(det, data["det_vars"])  # a second save replaces the first
    assert sorted(os.listdir(det)) == ["variables.pt"]
    # tensor leaves come back as numpy arrays of their dtype
    mixed = str(tmp_path / "mixed")
    save_checkpoint(mixed, {"a": torch.arange(3, dtype=torch.int32), "b": {"c": np.ones(2)}})
    assert_tree_equal(load_checkpoint(mixed),
                      {"a": np.arange(3, dtype=np.int32), "b": {"c": np.ones(2)}})
    with pytest.raises(ValueError, match="not a checkpoint"):
        load_checkpoint(str(tmp_path))

    outs = {}
    for name, extra in (("ncnn", ["--detector_param", data["param"], "--detector_bin",
                                  data["bin"], "--classifier", data["pth"]]),
                        ("ckpt", ["--detector", det, "--classifier", clf])):
        outs[name] = tmp_path / name
        assert port_e2e.main(_args(data, outs[name], *extra)) == 0
    _assert_same_outputs(outs["ckpt"], outs["ncnn"], "yolo_plus_v2+shufflenetv2")


@pytest.mark.parametrize("precision,tf32", [(None, False), ("default", False),
                                            ("high", True), ("highest", False)])
def test_matmul_precision_mapping(precision, tf32):
    """A float32 pipeline allows TF32 for "high" only, a bf16 pipeline
    never.  The choice is the pipeline's ``allow_tf32``: mapping it writes
    no process flag."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = not tf32
        assert port_e2e.MATMUL_TF32[precision] is tf32
        assert port_e2e.apply_matmul_precision(precision, torch.float32) is tf32
        assert port_e2e.apply_matmul_precision(precision, torch.bfloat16) is False
        assert [f.allow_tf32 for f in flags] == [not tf32, not tf32]
    finally:
        for f, s in zip(flags, saved):
            f.allow_tf32 = s


def test_device_cuda_needs_a_card(data, tmp_path):
    """``--device cuda`` (the default) raises without a card: no fallback."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    argv = [a for a in _args(data, tmp_path / "out") if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        port_e2e.main(argv)
