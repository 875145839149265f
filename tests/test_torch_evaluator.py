"""The port's ``PipelineEvaluator`` against the JAX package's on the same
variables and the same PNG frames on disk (``litepi_tpu_torch/pipeline/
evaluator.py``).

SMALL's float32 pipeline on the CPU, with the detector's three class-output
convs scaled by 3000 and the classifier's Dense by 300, so that candidate
scores and class probabilities spread over (0, 1) and lie further apart than
the frameworks' float noise, and the box outputs' DFL bins given a falling
bias, so that boxes are small enough for about ten per image to survive
NMS.  Five frames: two landscape 200x300, two
portrait 300x200, one landscape in a trailing partial batch (batch size 2),
with YOLO labels made from the JAX evaluator's own detections (some
jittered, some dropped, wrong classes, an empty label file and a missing
one), so the metric rows are neither 0 nor 1.

Both conf thresholds sit in gaps of the candidate scores (checked): every
score above them lies further than 1e-5 from the threshold and from every
other such score of its image, so both sides suppress in the same order.
Per-image tolerances: the same counts, boxes 1e-3 px (and no coordinate
within 1e-3 of an integer unless both sides hold the same value, so that
integer truncation cannot differ; checked), det scores 1e-6, labels exact,
cls scores 1e-5; metric rows within 1e-6 in the three metrics modes.
``write_results``' CSV and TXT artifacts are byte-equal to JAX's.
"""

import copy
import dataclasses
import math
import os

import cv2
import numpy as np
import pytest
import torch

from litepi_tpu.pipeline import TwoStagePipeline as JaxPipeline
from litepi_tpu.pipeline.evaluator import PipelineEvaluator as JaxEvaluator
from litepi_tpu.pipeline.evaluator import write_results as jax_write_results
from litepi_tpu_torch.pipeline import PipelineEvaluator, TwoStagePipeline, write_results
from tests.torch_port_helpers import (
    SMALL,
    jax_init_vars,
    one_torch_thread,  # noqa: F401 (a fixture, used by pytestmark)
    peaked_frames,
    port_config,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = dataclasses.replace(SMALL, batch_size=2, input_color="bgr")
SIZES = [(200, 300), (200, 300), (300, 200), (300, 200), (200, 300)]
SEPARATION = 1e-5
METRIC_KEYS = ("precision", "recall", "f1", "mAP50", "mAP50_95", "tp", "fp", "fn")


def spread_variables():
    det, clf = jax_init_vars(SMALL, seed=0)
    det, clf = copy.deepcopy(det), copy.deepcopy(clf)
    for i in range(3):
        det["params"]["head"][f"cls{i}_out"]["kernel"] = det["params"]["head"][f"cls{i}_out"]["kernel"] * 3000.0
    clf["params"]["fc"]["kernel"] = clf["params"]["fc"]["kernel"] * 300.0
    # DFL bins: a falling bias (side distances of about one bin) and a
    # scaled kernel, so that boxes are small and varied and survive NMS
    for i in range(3):
        out = det["params"]["head"][f"reg{i}_out"]
        out["kernel"] = out["kernel"] * 30.0
        out["bias"] = np.tile(-0.7 * np.arange(16, dtype=np.float32), 4)
    return det, clf


def frames_on_disk(root):
    paths = []
    for i, (h, w) in enumerate(SIZES):
        img = peaked_frames(seed=60 + i, batch=1, h=h, w=w)[0]
        p = os.path.join(root, f"frame{i}.png")
        cv2.imwrite(p, img)
        paths.append(p)
    return paths


def separated_conf(scores, lo, hi):
    """A threshold in a gap of ``scores`` (images x candidates) with
    ``lo``..``hi`` scores over it in every image, every score over it
    further than SEPARATION from it and from the others of its image."""
    flat = np.unique(scores.ravel())[::-1]
    for a, b in zip(flat[:-1], flat[1:]):
        conf = (float(a) + float(b)) / 2
        above = [np.sort(s[s > conf]) for s in scores]
        if not all(lo <= len(x) <= hi for x in above):
            continue
        if a - b > 2 * SEPARATION and all((np.diff(x) > SEPARATION).all() for x in above):
            return conf
    raise AssertionError("no well-separated conf threshold")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval"))
    det, clf = spread_variables()
    jax_ev = JaxEvaluator(JaxPipeline(CFG, det, clf))
    port_ev = PipelineEvaluator(
        TwoStagePipeline.from_jax_vars(port_config(CFG), det, clf, device="cpu"))
    paths = frames_on_disk(root)
    images = [cv2.imread(p) for p in paths]
    canvases, _ = jax_ev._letterbox_batch(images)
    cand = jax_ev.pipe.detect_candidates(canvases.astype(np.float32) / 255.0)
    scores = np.asarray(cand[1])
    yolo_conf = separated_conf(scores, 10, 22)
    bench_conf = separated_conf(scores[:, :CFG.nms.max_candidates], 3, 8)

    # labels from the JAX evaluator's own detections at yolo_conf
    labels_dir = os.path.join(root, "labels")
    os.makedirs(labels_dir)
    rng = np.random.default_rng(9)
    results = jax_ev.run_images(images, yolo_conf, eval_budget=True)
    for i, (p, img, res) in enumerate(zip(paths, images, results)):
        if i == 4:
            continue  # no label file: a negative image
        h, w = img.shape[:2]
        rows = []
        for b, c in zip(res["boxes"], res["labels"]):
            if i == 3 or rng.uniform() < 0.2:
                continue  # frame 3: an empty label file
            b = b + rng.normal(0, 3.0, 4)
            c = int(c) if rng.uniform() < 0.8 else (int(c) + 1) % 10
            cx, cy = (b[0] + b[2]) / 2 / w, (b[1] + b[3]) / 2 / h
            rows.append(f"{c} {cx:.6f} {cy:.6f} {(b[2] - b[0]) / w:.6f} {(b[3] - b[1]) / h:.6f}\n")
        stem = os.path.splitext(os.path.basename(p))[0]
        with open(os.path.join(labels_dir, stem + ".txt"), "w") as f:
            f.writelines(rows)
    return dict(jax=jax_ev, port=port_ev, paths=paths, images=images, labels=labels_dir,
                yolo_conf=yolo_conf, bench_conf=bench_conf, canvases=canvases)


def assert_same_results(got, want):
    assert len(got) == len(want)
    n = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g["boxes"]) == len(w["boxes"]), f"image {i}: counts differ"
        n += len(w["boxes"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-3, rtol=0)
        # truncation is safe: a coordinate either equals JAX's or lies
        # further than 1e-3 from every integer
        far = np.abs(w["boxes"] - np.round(w["boxes"])) > 1e-3
        assert (far | (g["boxes"] == w["boxes"])).all(), f"image {i}: a box edge at an integer"
        np.testing.assert_allclose(g["det_scores"], w["det_scores"], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["cls_scores"], w["cls_scores"], atol=1e-5, rtol=0)
        assert g["labels"].dtype == np.int32 and g["boxes"].dtype == np.float32
    assert n > 0


def test_canvas_upload_is_the_host_division(setup):
    """The uint8 canvases divided by 255 on the pipeline's device equal
    numpy's float32 ``/ 255.0`` bit for bit (every value 0..255)."""
    port = setup["port"]
    got = port._to_unit(setup["canvases"]).numpy()
    np.testing.assert_array_equal(got, setup["canvases"].astype(np.float32) / 255.0)
    ramp = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(port._to_unit(ramp).numpy(), ramp.astype(np.float32) / 255.0)


def test_host_crops_equal_jax(setup):
    """``_crop_rois``: int-truncated slices through ``cv2.resize``, equal to
    the JAX evaluator's crops (uint8 here, float32 there)."""
    img = setup["images"][0]
    boxes = np.array([[3.7, 5.2, 120.9, 80.1], [0, 0, 300, 200], [250.5, 150.5, 251.0, 151.0],
                      [-4, 190, 10, 240]], np.float32)
    np.testing.assert_array_equal(setup["port"]._crop_rois(img, boxes),
                                  setup["jax"]._crop_rois(img, boxes))


@pytest.mark.parametrize("eval_budget", [False, True])
def test_run_images_matches_jax(setup, eval_budget):
    conf = setup["yolo_conf"] if eval_budget else setup["bench_conf"]
    images = setup["images"][:4] + [None]  # an unreadable frame gives None
    want = setup["jax"].run_images(images, conf, eval_budget=eval_budget)
    got = setup["port"].run_images(images, conf, eval_budget=eval_budget)
    assert got[4] is None and want[4] is None
    assert_same_results(got[:4], want[:4])


def assert_same_metrics(got, want):
    for k in METRIC_KEYS:
        g, w = float(got[k]), float(want[k])
        assert (math.isnan(g) and math.isnan(w)) or abs(g - w) <= 1e-6, f"{k}: {g} != {w}"
    assert set(got.get("per_class", {})) == set(want.get("per_class", {}))
    for c, row in want.get("per_class", {}).items():
        for k, w in row.items():
            assert abs(float(got["per_class"][c][k]) - float(w)) <= 1e-6, (c, k)
    assert got["num_images"] == want["num_images"]
    assert got["metrics_mode"] == want["metrics_mode"]
    assert set(got["stage_ms_per_batch"]) == set(want["stage_ms_per_batch"])
    assert got["fps"] > 0


@pytest.mark.parametrize("mode", ["reference", "ultralytics", "level0"])
def test_evaluate_dataset_matches_jax(setup, mode):
    kw = dict(yolo_conf=setup["yolo_conf"], benchmark_conf=setup["bench_conf"], warmup=1,
              metrics_mode=mode)
    want = setup["jax"].evaluate_dataset(setup["paths"], setup["labels"], 10, **kw)
    got = setup["port"].evaluate_dataset(setup["paths"], setup["labels"], 10, **kw)
    assert_same_metrics(got, want)
    if mode == "reference":
        assert 0 < want["mAP50"] < 1 and 0 < want["f1"] < 1
        assert got["classes_present"] == want["classes_present"]
        assert got["ap50_per_class"].keys() == want["ap50_per_class"].keys()
    if mode == "level0":
        assert math.isnan(got["mAP50"]) and math.isnan(got["mAP50_95"])


def test_write_results_byte_equal(setup, tmp_path):
    """The same metrics dict through both ``write_results``: the summary,
    per-class, test-file, usage and stage artifacts byte for byte."""
    kw = dict(yolo_conf=setup["yolo_conf"], benchmark_conf=setup["bench_conf"], warmup=0)
    metrics = setup["port"].evaluate_dataset(setup["paths"], setup["labels"], 10, **kw)
    names = {0: "stop", 3: "yield"}
    for out, fn in (("port", write_results), ("jax", jax_write_results)):
        for combo in ("a", "b"):  # the summary appends a second row
            fn(str(tmp_path / out), combo, "yolo_plus", "shufflenetv2", metrics,
               setup["paths"], names)
    files = ["comparison_summary.csv"] + [
        f"{c}/{c}_{s}" for c in ("a", "b")
        for s in ("results.csv", "test_files.txt", "usage.csv", "stages.csv")]
    for f in files:
        got = (tmp_path / "port" / f).read_bytes()
        assert got == (tmp_path / "jax" / f).read_bytes(), f
    assert (tmp_path / "port" / "a" / "a_metrics.png").exists()


def test_viz_and_unknown_mode(setup, tmp_path):
    """``viz_dir``: one annotated image per image with labels, under the
    frame's file name, pixel-equal to the JAX evaluator's for the same
    results; an unknown metrics mode raises before any work."""
    kw = dict(yolo_conf=setup["yolo_conf"], benchmark_conf=setup["yolo_conf"], warmup=0)
    setup["port"].evaluate_dataset(setup["paths"][:2], setup["labels"], 10,
                                   viz_dir=str(tmp_path / "port"), **kw)
    img = cv2.imread(str(tmp_path / "port" / "frame0.png"))
    assert img is not None and img.shape == setup["images"][0].shape
    assert not np.array_equal(img, setup["images"][0])  # something was drawn
    res = setup["port"].run_images(setup["images"][:1], setup["yolo_conf"], eval_budget=True)[0]
    gt = np.array([[10.5, 20.2, 60.9, 70.0]], np.float32)
    names = {int(c): f"c{int(c)}" for c in res["labels"]}
    for side, ev in (("port", setup["port"]), ("jax", setup["jax"])):
        ev.class_names = names
        ev._save_viz(str(tmp_path / f"{side}_direct"), setup["paths"][0], setup["images"][0],
                     res, gt, setup["yolo_conf"])
        ev.class_names = {}
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port_direct" / "frame0.png")),
                                  cv2.imread(str(tmp_path / "jax_direct" / "frame0.png")))
    with pytest.raises(ValueError, match="metrics_mode"):
        setup["port"].evaluate_dataset(setup["paths"], setup["labels"], 10, metrics_mode="x")


def test_core_metrics_match_jax():
    """``core/metrics.py``: the same ``PipelineMetrics`` fields and
    defaults, the same percentile summaries and host counter keys as the
    JAX package's; ``StageTimer.sync`` walks nested containers and waits
    for nothing on the CPU."""
    import litepi_tpu.core.metrics as jax_metrics
    from litepi_tpu_torch.core import metrics

    assert metrics.PipelineMetrics().as_dict() == jax_metrics.PipelineMetrics().as_dict()
    lat = list(np.random.default_rng(1).exponential(3.0, 101))
    for data in ([], [2.5], lat):
        assert metrics.percentile_summary(data) == jax_metrics.percentile_summary(data)
    assert set(metrics.read_host_counters()) == set(jax_metrics.read_host_counters())
    t = metrics.StageTimer()
    tree = {"a": torch.ones(2), "b": [torch.zeros(1), (np.ones(1), 3)]}
    with t.stage("x"):
        assert t.sync(tree) is tree
    assert t.times_ms["x"] >= 0
