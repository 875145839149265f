"""Port models vs the JAX package through the weight bridge: the narrow
detector's reg/cls (folded and unfolded), the stem-input fold, and the
ShuffleNetV2 classifier's probabilities (litepi_tpu_torch/{models,weights}).

Tolerances: float32 on both sides; XLA's and oneDNN's convolutions sum in
different orders, so activations drift by ~1e-6 relative per layer.  The
head logits are O(1) and compared at 2e-4 absolute; probabilities at 1e-5.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from litepi_tpu.models import YoloLitePi as JaxYolo
from litepi_tpu.models import build_classifier as jax_build_classifier
from litepi_tpu.models.init_utils import fast_init
from litepi_tpu.weights.fold_bn import fold_batchnorm as jax_fold
from litepi_tpu.weights.fold_bn import fold_stem_input as jax_fold_stem
from litepi_tpu_torch.models import YoloLitePi, build_classifier
from litepi_tpu_torch.models.shufflenetv2 import channel_shuffle
from litepi_tpu_torch.weights import (
    fold_batchnorm,
    fold_stem_input,
    jax_to_state_dict,
)
from tests.torch_port_helpers import SMALL, jax_init_vars, perturb_batchnorm, port_config

HEAD_ATOL = 2e-4


@pytest.fixture(scope="module")
def variables():
    det, clf = jax_init_vars(SMALL, seed=0)
    return perturb_batchnorm(det, seed=1), perturb_batchnorm(clf, seed=2, spread=0.05)


# the narrow detector with yolo_plus_v1's widened PAN down convs, and with
# stock YOLOv8's plain (non-residual) neck
NECK_VARIANTS = {
    "v1_neck": dict(neck_down_base=(256, 512)),
    "v8_neck": dict(neck_shortcut=False),
}


@pytest.mark.parametrize("variant", list(NECK_VARIANTS))
def test_detector_variants_match_jax(variant):
    det_cfg = dataclasses.replace(SMALL.detector, **NECK_VARIANTS[variant])
    jvars = perturb_batchnorm(fast_init(JaxYolo(det_cfg), seed=4), seed=5)
    x = _canvas(8)
    want = JaxYolo(det_cfg).apply(jvars, x, train=False)
    cfg = port_config(dataclasses.replace(SMALL, detector=det_cfg))
    model = YoloLitePi(cfg.detector)
    model.load_state_dict(jax_to_state_dict(jvars))
    with torch.no_grad():
        got = model.eval()(_nchw(x))
    for k in ("reg", "cls"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=HEAD_ATOL, rtol=0)


def _port_detector(state, fused):
    model = YoloLitePi(port_config(SMALL).detector, fused=fused)
    model.load_state_dict(state)
    return model.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _canvas(seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (2, 160, 160, 3)).astype(np.float32)


@pytest.mark.parametrize("fused", [False, True])
def test_detector_matches_jax(variables, fused):
    det, _ = variables
    x = _canvas(5)
    jvars = jax_fold(det) if fused else det
    want = JaxYolo(SMALL.detector, fused=fused).apply(jvars, x, train=False)
    state = jax_to_state_dict(det)
    if fused:
        state = fold_batchnorm(state)
    with torch.no_grad():
        got = _port_detector(state, fused)(_nchw(x))
    assert got["reg"].shape == (2, SMALL.detector.num_anchors, 64)
    assert got["cls"].shape == (2, SMALL.detector.num_anchors, 1)
    for k in ("reg", "cls"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=HEAD_ATOL, rtol=0)


def test_fold_is_bit_equal_to_jax(variables):
    """Port fold on the bridged state == bridge of the JAX fold, bit for bit."""
    det, _ = variables
    a = fold_batchnorm(jax_to_state_dict(det))
    b = jax_to_state_dict(jax_fold(det))
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("flip", [False, True])
def test_stem_input_fold(variables, flip):
    """Raw 0-255 input through the folded stem (from_stem) equals the JAX
    deploy model fed flipped, 1/255-scaled input."""
    det, _ = variables
    x255 = _canvas(6) * 255.0
    folded = jax_fold(det)
    raw_vars = jax_fold_stem(folded, 1.0 / 255.0, flip)
    want = JaxYolo(SMALL.detector, fused=True).apply(raw_vars, x255, train=False)

    state = fold_batchnorm(jax_to_state_dict(det))
    model = _port_detector(state, True)
    w = fold_stem_input(state["backbone.stem.conv.weight"], 1.0 / 255.0, flip)
    assert torch.equal(
        w, jax_to_state_dict(raw_vars)["backbone.stem.conv.weight"]
    )
    with torch.no_grad():
        stem = torch.nn.functional.silu(
            torch.nn.functional.conv2d(
                _nchw(x255), w, state["backbone.stem.conv.bias"], stride=2, padding=1
            )
        )
        got = model(stem, from_stem=True)
        ref = model(_nchw((x255[..., ::-1] if flip else x255) / 255.0))
    for k in ("reg", "cls"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=HEAD_ATOL, rtol=0)
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=HEAD_ATOL, rtol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_classifier_probs_match_jax(variables, fused):
    _, clf = variables
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (5, 64, 64, 3)).astype(np.float32)
    jvars = jax_fold(clf, eps=1e-5) if fused else clf
    logits = jax_build_classifier("shufflenetv2", 10, fused=fused).apply(jvars, x, train=False)
    want = np.asarray(jax.nn.softmax(logits, axis=-1))
    state = jax_to_state_dict(clf)
    if fused:
        state = fold_batchnorm(state, eps=1e-5)
    model = build_classifier("shufflenetv2", 10, fused=fused)
    model.load_state_dict(state)
    with torch.no_grad():
        got = torch.softmax(model.eval()(_nchw(x)), -1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_channel_shuffle_permutation():
    x = torch.arange(12.0).view(1, 12, 1, 1)
    out = channel_shuffle(x, 2).flatten().tolist()
    assert out == [(j % 2) * 6 + j // 2 for j in range(12)]


def test_unported_classifiers_raise():
    """All four reference classifiers build, unfused and deploy-form, with
    a float32 ``fc`` head; an arch the registry does not hold raises."""
    for arch in ("shufflenetv2", "resnet18", "mobilenetv2", "efficientnet"):
        for fused in (False, True):
            model = build_classifier(arch, 10, fused=fused)
            assert model.fc.out_features == 10 and model.fc.weight.dtype == torch.float32
            assert any(k.endswith(".running_var") for k in model.state_dict()) != fused
    with pytest.raises(ValueError, match="unknown classifier"):
        build_classifier("vgg", 10)
