"""The port's TwoStagePipeline with the zoo's detectors and classifiers
against the JAX package's on the same variables: YOLOv11n + ResNet18
(``run_fused``, ``detect``, ``detect_candidates``) and the anchor-based
YOLOv5n + EfficientNet-B0 through its candidate decoder and capacity
(``detect_candidates`` over every prediction, ``run_fused``).

Both sides take the detector injected (``det_model``), so it runs with its
BatchNorm, on letterboxed canvases x 1/255.  Float32 on the CPU at a 160
input (the detectors at full width), 10 classes, BatchNorm statistics
perturbed, the peaked scene of tests/test_pipeline.py.  The conf threshold
is the middle of a gap of the JAX candidate scores wider than 4e-6, so
float noise cannot flip a discrete decision; tolerances are
tests/test_torch_pipeline.py's.  A bfloat16 run of each serving pair
checks the contract's shapes, dtypes and finiteness; its values are held
against the JAX package's bf16 program in
tests/test_torch_bf16_zoo_parity.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litepi_tpu.core.types import YOLOV8N, NMSConfig, PipelineConfig
from litepi_tpu.models import build_classifier as jax_build_classifier
from litepi_tpu.models.init_utils import fast_init
from litepi_tpu.models.yolov5 import YoloV5 as JaxYoloV5
from litepi_tpu.models.yolov5 import v5_anchor_table, v5_candidates
from litepi_tpu.models.yolov11 import YoloV11 as JaxYoloV11
from litepi_tpu.ops.letterbox import letterbox_device as jax_letterbox
from litepi_tpu.pipeline import TwoStagePipeline as JaxPipeline
from litepi_tpu_torch.models import YoloV11, detector_kwargs
from litepi_tpu_torch.pipeline import TwoStagePipeline
from tests.test_torch_staged import _assert_same_candidates
from tests.torch_port_helpers import peaked_frames, perturb_batchnorm, port_config

ZOO = PipelineConfig(
    detector=dataclasses.replace(YOLOV8N, input_size=160),
    nms=NMSConfig(max_candidates=128, max_detections=8, min_area=4.0),
    num_classifier_classes=10,
    det_input_size=160,
    cls_input_size=64,
)
# (detector, classifier arch, extra config) per pair
PAIRS = {
    "v11_resnet18": ("yolov11n", "resnet18",
                     dict(input_color="bgr", crop_det_budget=4, cls_crop_budget=6)),
    "v5legacy_efficientnet": ("yolov5n_legacy", "efficientnet", {}),
}
EXACT = ("valid", "det_class_ids", "cls_labels")
CLOSE = {"det_scores": 1e-6, "boxes": 1e-3, "cls_probs": 1e-5, "cls_scores": 1e-5}


def conf_in_gap(scores, min_above=2, max_above=7, gap=4e-6):
    """A conf threshold for float-noise-proof comparisons: the middle of the
    widest gap (wider than ``gap``) between adjacent candidate scores of
    all frames together, with ``min_above`` to ``max_above`` scores over it
    in every frame."""
    scores = np.asarray(scores)
    flat = np.sort(scores.ravel())[::-1]
    best = None
    for hi, lo in zip(flat[:-1], flat[1:]):
        conf = (float(hi) + float(lo)) / 2
        above = (scores > conf).sum(-1)
        if hi - lo > gap and above.min() >= min_above and above.max() <= max_above:
            if best is None or hi - lo > best[0]:
                best = (hi - lo, conf)
    assert best is not None, "no conf threshold in a clear gap"
    return best[1]


def _jax_detector(variant):
    if variant == "yolov11n":
        return JaxYoloV11(num_classes=1)
    return JaxYoloV5(anchor_free=variant == "yolov5n")


def _pipelines(pair, dtype=torch.float32):
    """(JAX pipeline, port pipeline) of ``pair`` on the same variables."""
    variant, arch, extra = PAIRS[pair]
    cfg = dataclasses.replace(ZOO, classifier_arch=arch, **extra)
    jdet = _jax_detector(variant)
    det = perturb_batchnorm(fast_init(jdet, seed=1), seed=2)
    clf = perturb_batchnorm(
        fast_init(jax_build_classifier(arch, 10), seed=3, spatial=64), seed=4, spread=0.05)
    jkw = {}
    if variant == "yolov5n_legacy":  # as litepi_tpu/apps/e2e.py wires it
        tables = [jnp.asarray(t) for t in v5_anchor_table(cfg.det_input_size)]
        jkw = dict(candidate_decoder=lambda out, k: v5_candidates(out["pred"], *tables, k),
                   candidate_capacity=int(tables[0].shape[0]))
    jp = JaxPipeline(cfg, det, clf, det_model=jdet, **jkw)
    pcfg = port_config(cfg)
    port = TwoStagePipeline.from_jax_vars(
        pcfg, det, clf, dtype=dtype, device="cpu", **detector_kwargs(variant, pcfg, "cpu"))
    return jp, port


@pytest.fixture(scope="module", params=list(PAIRS))
def pair(request):
    jp, port = _pipelines(request.param)
    frames = peaked_frames()
    canvas = jax_letterbox(frames, ZOO.det_input_size, jnp.float32)
    canvas01 = np.asarray(canvas) / np.float32(255.0)
    # the conf threshold from the candidates the fused program ranks
    conf = conf_in_gap(jp._detect_jit(jp.det_vars, canvas01)[1])
    return request.param, jp, port, frames, canvas01, conf


def test_run_fused_matches_jax(pair):
    name, jp, port, frames, _, conf = pair
    want = {k: np.asarray(v) for k, v in jp.run_fused(frames, conf).items()}
    got = {k: v.numpy() for k, v in port.run_fused(frames, conf).items()}
    assert set(got) == set(want)
    for k in EXACT:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, tol in CLOSE.items():
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0, err_msg=k)
    assert want["valid"].any() and not want["valid"].all(), name


def test_detect_matches_jax(pair):
    _, jp, port, _, canvas01, conf = pair
    want = {k: np.asarray(v) for k, v in jp.detect(canvas01, conf).items()}
    got = {k: v.numpy() for k, v in port.detect(canvas01, conf).items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["class_ids"], want["class_ids"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-3, rtol=0)
    assert want["valid"].any()


def test_detect_candidates_every_prediction(pair):
    """``eval_max_candidates`` 0: every prediction, K = the capacity: the
    525 anchors of the anchor-free grid at 160, 3 x 525 for the
    anchor-based head (its declared ``candidate_capacity``)."""
    name, jp, port, _, canvas01, _ = pair
    want = [np.asarray(x) for x in jp.detect_candidates(canvas01)]
    got = [x.numpy() for x in port.detect_candidates(canvas01)]
    assert got[1].shape == (2, 525 if name.startswith("v11") else 1575)
    _assert_same_candidates(got, want)


@pytest.mark.parametrize("variant, arch", [
    ("yolov11n", "resnet18"), ("yolov5n", "mobilenetv2"), ("yolov5n_legacy", "efficientnet"),
])
def test_bfloat16_zoo_pipeline_runs(variant, arch):
    """The three serving pairs in bf16 (weights and activations, BatchNorm
    included; decode and softmax in f32), from ``initialize``'s seeded
    weights: shapes, dtypes, finite values, probabilities summing to 1."""
    cfg = port_config(dataclasses.replace(ZOO, classifier_arch=arch, input_color="bgr"))
    port = TwoStagePipeline.initialize(cfg, seed=5, dtype=torch.bfloat16, device="cpu",
                                       **detector_kwargs(variant, cfg, "cpu"))
    assert next(port.det_model.parameters()).dtype == torch.bfloat16
    out = port.run_fused(peaked_frames(), 0.25)
    d = cfg.nms.max_detections
    assert out["boxes"].shape == (2, d, 4) and out["boxes"].dtype == torch.float32
    assert out["cls_probs"].shape == (2, d, 10) and out["cls_probs"].dtype == torch.float32
    assert out["det_class_ids"].dtype == torch.int32 and out["valid"].dtype == torch.bool
    assert out["valid"].any()
    for v in out.values():
        assert torch.isfinite(v.double()).all()
    torch.testing.assert_close(
        out["cls_probs"].sum(-1), torch.ones(out["valid"].shape), atol=1e-4, rtol=0)
    n = port.detect_candidates(peaked_frames()[..., :160, :160, :] / 255.0)[1].shape[1]
    assert n == (1575 if variant == "yolov5n_legacy" else 525)


def test_injected_detector_skips_the_stem_kernel(monkeypatch):
    """Canvas-sized frames take the stem kernel only on the default
    detector: an injected one gets the letterbox, x 1/255 and the flip, and
    equals the staged ``detect`` on the same canvases."""
    import litepi_tpu_torch.pipeline.two_stage as port_module

    def no_stem(*args):
        raise AssertionError("the stem kernel ran for an injected detector")

    monkeypatch.setattr(port_module, "fused_stem", no_stem)
    cfg = port_config(dataclasses.replace(ZOO, classifier_arch="resnet18", input_color="bgr"))
    port = TwoStagePipeline.initialize(cfg, seed=6, device="cpu",
                                       **detector_kwargs("yolov11n", cfg, "cpu"))
    frames = peaked_frames(seed=17, h=160, w=160)
    out = port.run_fused(frames, 0.0)
    staged = port.detect(frames / np.float32(255.0), 0.0)
    np.testing.assert_allclose(out["det_scores"].numpy(), staged["scores"][:, :8].numpy(),
                               atol=1e-6, rtol=0)


def test_detector_kwargs():
    """The e2e app's wiring from the pipeline config: a det_model for each
    variant with ``cfg.detector``'s class count, and the anchor-based
    head's decoder and capacity at ``cfg.det_input_size`` (3 x 8,400 at
    640)."""
    cfg = port_config(dataclasses.replace(
        ZOO, detector=dataclasses.replace(YOLOV8N, num_classes=3), det_input_size=640))
    v11 = detector_kwargs("yolov11n", cfg, "cpu")["det_model"]
    assert isinstance(v11, YoloV11) and v11.num_classes == 3
    v5u = detector_kwargs("yolov5n", cfg, "cpu")["det_model"]
    assert v5u.anchor_free and v5u.num_classes == 3
    kw = detector_kwargs("yolov5n_legacy", cfg, "cpu")
    assert not kw["det_model"].anchor_free and kw["det_model"].num_classes == 3
    assert kw["candidate_capacity"] == 25200
    assert kw["candidate_decoder"].grid_xy.shape == (25200, 2)
    with pytest.raises(ValueError, match="unknown detector variant"):
        detector_kwargs("yolov8n", cfg, "cpu")
