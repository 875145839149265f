"""The port's detector and classifier benches (``litepi_tpu_torch/bench/
{detector,classifier}_bench.py``) against the JAX package's on the CPU.

Tolerances: ``DetectorHarness.unmap_boxes`` equal for both geometries;
``evaluate_detector``'s metric row within 1e-6 on a labelled folder
written here (the tiny Faster R-CNN at input 64 with the same seeded
variables on both sides, labels from the port's own detections,
jittered, so that the row is neither 0 nor 1); ``macro_prf1``,
``confusion_analysis`` and ``predict_topk`` equal (probabilities within
1e-6); ``evaluate_classifier``'s accuracy and macro P / R / F1 equal to
those of the JAX model's predictions, parameters and size equal to the JAX
bench's ``count_params`` / ``model_size_mb``."""

import os

import cv2
import jax
import numpy as np
import pytest
import torch

import litepi_tpu.bench.classifier_bench as jcb
import litepi_tpu.bench.detector_bench as jdb
import litepi_tpu_torch.bench.classifier_bench as pcb
import litepi_tpu_torch.bench.detector_bench as pdb
from litepi_tpu.models import build_classifier as jax_build_classifier
from litepi_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)
from tests.torch_port_helpers import random_jax_vars

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("geometry", ["letterbox", "resize"])
def test_unmap_boxes_matches_jax(geometry):
    rng = np.random.default_rng(0)
    boxes = rng.uniform(-20, 660, (7, 4)).astype(np.float32)
    for w, h in ((1920, 1080), (300, 500)):
        args = ("v", 640, geometry, None, None, None)
        want = jdb.DetectorHarness(*args).unmap_boxes(boxes.copy(), w, h)
        got = pdb.DetectorHarness(*args).unmap_boxes(boxes.copy(), w, h)
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def det_vars():
    return random_jax_vars(JaxFasterRCNN(num_classes=2, input_size=64, pre_nms_topk=64,
                                         post_nms_topk=16), seed=3, spatial=64)


@pytest.fixture(scope="module")
def folder(tmp_path_factory, det_vars):
    """5 frames of mixed sizes with bright blocks; labels from the port's
    own top-4 detections, jittered by 0.3 px, some dropped or given the
    other class, one frame without a label file."""
    root = tmp_path_factory.mktemp("det_eval")
    img_dir, lbl_dir = str(root / "images"), str(root / "labels")
    os.makedirs(img_dir)
    os.makedirs(lbl_dir)
    rng = np.random.default_rng(1)
    h_port = pdb.make_harness("faster_rcnn", input_size=64, dtype="float32", num_classes=2,
                              conf=0.05, iou=0.45, max_detections=4, det_vars=det_vars,
                              input_color="bgr", device="cpu")
    for i, (h, w) in enumerate(((72, 96), (96, 72), (64, 64), (80, 120), (90, 90))):
        img = rng.integers(0, 100, (h, w, 3), dtype=np.uint8)
        img[h // 4: h // 2, w // 4: w // 2] = 240
        path = os.path.join(img_dir, f"f{i}.jpg")
        cv2.imwrite(path, img)
        canvas = cv2.resize(cv2.imread(path), (64, 64), interpolation=cv2.INTER_LINEAR)
        b, s, c, v = (t.numpy() for t in h_port.predict(torch.from_numpy(canvas[None])))
        if i == 4:
            continue
        rows = []
        for box, cls in zip(h_port.unmap_boxes(b[0][v[0]], w, h), c[0][v[0]]):
            if rng.uniform() < 0.3:
                continue
            box = box + rng.normal(0, 0.3, 4)
            cls = 1 - cls if rng.uniform() < 0.2 else cls
            rows.append(f"{int(cls)} {(box[0] + box[2]) / 2 / w:.6f} {(box[1] + box[3]) / 2 / h:.6f} "
                        f"{abs(box[2] - box[0]) / w:.6f} {abs(box[3] - box[1]) / h:.6f}\n")
        with open(os.path.join(lbl_dir, f"f{i}.txt"), "w") as f:
            f.writelines(rows)
    return img_dir, lbl_dir


def test_evaluate_detector_row_matches_jax(det_vars, folder):
    kw = dict(det_vars=det_vars, num_classes=2, input_size=64)
    want = jdb.evaluate_detector("faster_rcnn", *folder, **kw)
    got = pdb.evaluate_detector("faster_rcnn", *folder, device="cpu", **kw)
    assert set(got) == set(want) and got["num_images"] == want["num_images"] == 5
    for k in ("mAP50", "mAP50_95", "precision", "recall"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert 0 < want["mAP50"] < 1


def _tf32_flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def test_evaluate_detector_runs_float32_without_tf32_and_gives_the_flags_back(
        det_vars, folder, monkeypatch):
    """Every float32 stage (``pre``'s resize, ``infer``'s RPN NMS,
    ``post``) sees TF32 off; the caller's flags (here on) are the same
    after the call, so a training run's steps after its validation compute
    as those before it."""
    import litepi_tpu_torch.models.faster_rcnn as pfr
    import litepi_tpu_torch.ops.resize as presize

    seen = {}

    def spy(stage, fn):
        def run(*a, **kw):
            seen.setdefault(stage, set()).add(_tf32_flags())
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(presize, "resize_bilinear", spy("pre", presize.resize_bilinear))
    monkeypatch.setattr(pfr, "suppress", spy("infer", pfr.suppress))
    monkeypatch.setattr(pfr, "postprocess_detections",
                        spy("post", pfr.postprocess_detections))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    pdb.evaluate_detector("faster_rcnn", *folder, det_vars=det_vars, num_classes=2,
                          input_size=64, max_images=2, device="cpu")
    assert seen == {stage: {(False, False)} for stage in ("pre", "infer", "post")}
    assert _tf32_flags() == (True, True)


def test_macro_prf1_and_confusion_analysis_match_jax():
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 7, 200)
    labels[labels == 5] = 4  # a class absent from the labels
    preds = np.where(rng.uniform(size=200) < 0.7, labels, rng.integers(0, 7, 200))
    assert pcb.macro_prf1(preds, labels, 7) == jcb.macro_prf1(preds, labels, 7)
    names = {i: f"c{i}" for i in range(7)}
    for kw in ({}, {"class_names": names, "top": 3}):
        got = pcb.confusion_analysis(preds, labels, 7, **kw)
        want = jcb.confusion_analysis(preds, labels, 7, **kw)
        np.testing.assert_array_equal(got.pop("confusion_matrix"), want.pop("confusion_matrix"))
        assert got == want


@pytest.fixture(scope="module")
def classifier():
    model = jax_build_classifier("shufflenetv2", 10)
    variables = random_jax_vars(model, seed=4, spatial=32)
    rng = np.random.default_rng(5)
    images = rng.normal(0, 1, (24, 32, 32, 3)).astype(np.float32)
    logits = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, images))
    return variables, images, logits


def test_predict_topk_matches_jax(classifier):
    variables, images, _ = classifier
    names = {i: f"sign{i}" for i in range(10)}
    want = jcb.predict_topk("shufflenetv2", variables, images[0], 10, 3, names)
    got = pcb.predict_topk("shufflenetv2", variables, images[0], 10, 3, names, device="cpu")
    assert [g["class_id"] for g in got] == [w["class_id"] for w in want]
    assert [g["class_name"] for g in got] == [w["class_name"] for w in want]
    np.testing.assert_allclose([g["prob"] for g in got], [w["prob"] for w in want], atol=1e-6)


def test_evaluate_classifier_matches_jax_predictions(classifier):
    variables, images, logits = classifier
    labels = np.where(np.arange(24) % 3 == 0, logits.argmax(-1), np.arange(24) % 10)
    row = pcb.evaluate_classifier("shufflenetv2", variables, images, labels, 10, batch=16,
                                  warmup=1, timed_iters=2, device="cpu")
    preds = logits.argmax(-1)
    assert row["accuracy"] == float((preds == labels).mean())
    p, r, f1 = jcb.macro_prf1(preds, labels, 10)
    assert (row["precision_macro"], row["recall_macro"], row["f1_macro"]) == (p, r, f1)
    assert row["params"] == jcb.count_params(variables)
    assert row["size_mb"] == round(jcb.model_size_mb(variables), 2)
    assert row["fps"] > 0 and row["batch"] == 16


def test_evaluate_classifier_gives_the_tf32_flags_back(classifier, monkeypatch):
    """The classifier bench runs with TF32 off and leaves the caller's
    flags (here on) as they were."""
    import litepi_tpu_torch.models as pmodels

    variables, images, _ = classifier
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = set()
    build = pmodels.build_classifier

    def spy(*a, **kw):
        model = build(*a, **kw)
        model.register_forward_pre_hook(lambda *_: seen.add(_tf32_flags()))
        return model

    monkeypatch.setattr(pmodels, "build_classifier", spy)
    pcb.evaluate_classifier("shufflenetv2", variables, images[:4], np.zeros(4, np.int64), 10,
                            batch=4, warmup=1, timed_iters=1, device="cpu")
    assert seen == {(False, False)} and _tf32_flags() == (True, True)
