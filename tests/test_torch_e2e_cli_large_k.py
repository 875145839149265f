"""The port's e2e CLI above 1,024 NMS candidates against the JAX CLI, both
``--device cpu``: at a 320 input the anchor grid holds 2,100 predictions
(40^2 + 20^2 + 10^2), and ``--max_candidates 2100`` sends every one of them
to the device NMS (the NMS kernel on the card, ``suppress_sorted`` here)
with no top-K cut, as users run it to score the whole PR curve.  The same
deployed artifacts and dataset recipe as tests/test_torch_e2e_cli.py (an
NCNN yolo_plus_v2 pair whose candidate scores spread over (0.5, 1), a
ShuffleNetV2 ``.pth``, labels from the port's own detections, jittered);
the benchmark threshold in a gap of all 2,100 scores.  The metric columns
of ``comparison_summary.csv`` must be equal and the per-class rows within
tests/test_torch_evaluator.py's tolerances."""

import os

import cv2
import numpy as np
import pytest
import torch

from litepi_tpu.core.types import YOLO_PLUS_V2
from litepi_tpu.weights import ncnn_export
from litepi_tpu_torch.apps import e2e as port_e2e
from litepi_tpu_torch.ops import nms as nms_ops
from tests.test_torch_e2e_cli import _assert_same_outputs, _detector_vars, _write_labels
from tests.test_torch_evaluator import separated_conf
from tests.torch_port_helpers import one_torch_thread, peaked_frames  # noqa: F401
from tests.torch_refs import ShuffleNetV2T

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NUM_CLASSES, SIZE, K = 10, 320, 2100
SIZES = [(400, 640), (480, 640), (640, 400)]
COMMON = ["--num_classes", str(NUM_CLASSES), "--det_input_size", str(SIZE), "--batch_size", "2",
          "--max_det", "8", "--max_candidates", str(K), "--num_samples", "3", "--device", "cpu",
          "--warmup", "1"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from litepi_tpu_torch.core import types as T
    from litepi_tpu_torch.pipeline import PipelineEvaluator, TwoStagePipeline
    from litepi_tpu_torch.weights.ncnn_import import convert_detector_ncnn
    from litepi_tpu_torch.weights.torch_import import (
        convert_classifier_state_dict,
        load_torch_state_dict,
    )

    root = tmp_path_factory.mktemp("cli_large_k")
    d = {k: str(root / k) for k in ("images", "labels")}
    for k in ("images", "labels"):
        os.makedirs(d[k])
    paths = []
    for i, (h, w) in enumerate(SIZES):
        paths.append(os.path.join(d["images"], f"img{i}.jpg"))
        cv2.imwrite(paths[-1], peaked_frames(seed=120 + i, batch=1, h=h, w=w)[0])
    d["param"], d["bin"] = str(root / "det.param"), str(root / "det.bin")
    ncnn_export.export_detector_ncnn(_detector_vars(), YOLO_PLUS_V2, d["param"], d["bin"])
    torch.manual_seed(22)
    clf = ShuffleNetV2T(NUM_CLASSES)
    with torch.no_grad():
        clf.fc.weight *= 300.0
    d["pth"] = str(root / "shufflenetv2.pth")
    torch.save(clf.state_dict(), d["pth"])

    det_vars = convert_detector_ncnn(d["param"], d["bin"])[0]
    cls_vars = convert_classifier_state_dict("shufflenetv2", load_torch_state_dict(d["pth"]))
    cfg = T.PipelineConfig(
        detector=T.DetectorConfig(input_size=SIZE), nms=T.NMSConfig(max_candidates=K,
                                                                    max_detections=8),
        num_classifier_classes=NUM_CLASSES, det_input_size=SIZE, batch_size=2,
        input_color="bgr")
    ev = PipelineEvaluator(TwoStagePipeline.from_jax_vars(cfg, det_vars, cls_vars, device="cpu"))
    images = [cv2.imread(p) for p in paths]
    scores = ev.pipe.detect_candidates(ev._to_unit(ev._letterbox_batch(images)[0]))[1].numpy()
    assert scores.shape == (len(SIZES), K)
    d["yolo_conf"] = separated_conf(scores, 3, 60)
    d["bench_conf"] = separated_conf(scores, 4, 40)
    results = ev.run_images(images, d["yolo_conf"], eval_budget=True)
    _write_labels(d["labels"], paths, results, np.random.default_rng(26))
    return d


def test_cli_at_every_prediction_matches_jax(data, tmp_path, monkeypatch):
    from litepi_tpu.apps import e2e as jax_e2e

    ks = []
    real = nms_ops.suppress
    monkeypatch.setattr(nms_ops, "suppress", lambda b, *a: (ks.append(b.shape[-2]), real(b, *a))[1])
    outs = {}
    for name, main in (("jax", jax_e2e.main), ("port", port_e2e.main)):
        outs[name] = tmp_path / name
        assert main(["--input", data["images"], "--labels", data["labels"], "--output",
                     str(outs[name]), "--yolo_conf", repr(data["yolo_conf"]),
                     "--benchmark_conf", repr(data["bench_conf"]), "--detector_param",
                     data["param"], "--detector_bin", data["bin"], "--classifier", data["pth"],
                     *COMMON]) == 0
    assert ks and set(ks) == {K}  # the port's device NMS ran at every prediction
    _assert_same_outputs(outs["port"], outs["jax"], "yolo_plus_v2+shufflenetv2")
