"""Shared fixtures of the port's tests (``tests/test_torch_*.py``).

The JAX package is the reference: inputs are made with numpy from a seed
and go through the JAX function and its ``litepi_tpu_torch`` counterpart;
weights are made by the JAX package's own init and carried into the port
through ``litepi_tpu_torch.weights.jax_bridge``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from litepi_tpu.core.types import DetectorConfig, NMSConfig, PipelineConfig

# tests/test_pipeline.py's narrow pipeline: base widths 32..512, input 160,
# a 10-class ShuffleNetV2
SMALL = PipelineConfig(
    detector=DetectorConfig(
        name="tiny", base_channels=(32, 64, 128, 256, 512), input_size=160
    ),
    nms=NMSConfig(max_candidates=128, max_detections=8, min_area=4.0),
    classifier_arch="shufflenetv2",
    num_classifier_classes=10,
    det_input_size=160,
    cls_input_size=64,
)


def port_config(cfg):
    """The port's copy of a JAX ``PipelineConfig`` (same fields)."""
    from litepi_tpu_torch.core import types as T

    d = dataclasses.asdict(cfg)
    det = T.DetectorConfig(**d.pop("detector"))
    nms = T.NMSConfig(**d.pop("nms"))
    return T.PipelineConfig(detector=det, nms=nms, **d)


def jax_init_vars(cfg, seed=0):
    """Unfolded JAX variables of the detector and classifier, as the JAX
    ``TwoStagePipeline.initialize`` makes them (numpy trees)."""
    from litepi_tpu.models import YoloLitePi, build_classifier
    from litepi_tpu.models.init_utils import fast_init

    det = fast_init(YoloLitePi(cfg.detector), seed=seed)
    clf = fast_init(
        build_classifier(cfg.classifier_arch, cfg.num_classifier_classes),
        seed=seed + 1,
        spatial=cfg.cls_input_size,
    )
    return det, clf


def perturb_batchnorm(variables, seed=0, spread=0.1):
    """Copy of ``variables`` with random BatchNorm scale/bias/mean/var, so
    that folding is exercised (an identity-init BN folds trivially)."""
    rng = np.random.default_rng(seed)

    def walk(node, stats):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, stats)
            elif stats and k == "var":
                out[k] = rng.uniform(1 - 5 * spread, 1 + 5 * spread, v.shape).astype(np.float32)
            elif stats and k == "mean":
                out[k] = rng.normal(0, spread, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    def walk_params(node, in_bn=False):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk_params(v, k.startswith("bn"))
            elif in_bn and k == "scale":
                out[k] = rng.uniform(1 - 2 * spread, 1 + 2 * spread, v.shape).astype(np.float32)
            elif in_bn and k == "bias":
                out[k] = rng.normal(0, spread, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return {
        "params": walk_params(variables["params"]),
        "batch_stats": walk(variables["batch_stats"], True),
    }


def peaked_frames(seed=11, batch=2, h=200, w=300):
    """tests/test_pipeline.py's peaked scene: bright blocks on a dark field,
    so that random-init detector scores separate clearly from the flat
    background (float noise between the two frameworks then cannot
    reorder the candidates that clear the conf threshold)."""
    rng = np.random.default_rng(seed)
    frames = (rng.uniform(0, 0.25, (batch, h, w, 3)) * 255).astype(np.uint8)
    for i in range(batch):
        for k in range(3):
            x, y = 40 + 80 * k, 50 + 40 * i
            frames[i, y : y + 40, x : x + 40] = 255
    return frames


# Per host colour order: the seed of canvas_frames() and a conf threshold
# in the middle of a 4.3e-6 (bgr) or 5.5e-6 (rgb) gap of its candidate
# scores under jax_init_vars(SMALL, 0); at least 13 candidates per frame
# clear it.
CANVAS_SCENES = {"rgb": (17, 0.5000627), "bgr": (35, 0.50006235)}


def canvas_frames(input_color="rgb"):
    """The peaked scene at SMALL's detector input size (2 frames of
    160x160), so the letterbox is the identity and the port's stem kernel
    branch runs."""
    seed = CANVAS_SCENES[input_color][0]
    return peaked_frames(seed=seed, h=SMALL.det_input_size, w=SMALL.det_input_size)


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch on one thread for a module's tests, then back.  The fast lane
    runs six workers on the host's cores, and each worker's own torch
    thread pool oversubscribes them: a module of many small torch calls ran
    15-40x slower there than alone.  Use it as ``pytestmark =
    pytest.mark.usefixtures("one_torch_thread")`` with the fixture
    imported."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_jax_vars(model, seed=0, spatial=64):
    """Seeded numpy variables of a flax ``model``, shaped by
    ``jax.eval_shape`` of its init (a trace, no compile: much cheaper than
    ``fast_init`` for the full-width detectors).  Kernels N(0, 1/fan_in),
    biases and BatchNorm biases and means N(0, 0.1), BatchNorm scales
    around 1, variances in [0.5, 1.5]: weights for importer round trips,
    where any values do."""
    import jax

    x = np.zeros((1, spatial, spatial, 3), np.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), x, train=False))
    rng = np.random.default_rng(seed)

    def fill(node, stats):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = fill(v, stats)
                continue
            shape = tuple(v.shape)
            if k == "kernel":
                fan_in = int(np.prod(shape[:-1])) or 1
                a = rng.normal(0, 1 / np.sqrt(fan_in), shape)
            elif k == "var":
                a = rng.uniform(0.5, 1.5, shape)
            elif k == "scale":
                a = rng.uniform(0.8, 1.2, shape)
            else:
                a = rng.normal(0, 0.1, shape)
            out[k] = a.astype(np.float32)
        return out

    return {c: fill(t, c == "batch_stats") for c, t in shapes.items()}


def assert_tree_equal(got, want, path=""):
    """The same nested keys, and every leaf equal bit for bit
    (``np.array_equal``) with the same dtype."""
    assert isinstance(got, dict) and isinstance(want, dict), path
    assert sorted(got) == sorted(want), f"{path}: keys {sorted(got)} != {sorted(want)}"
    for k in want:
        if isinstance(want[k], dict):
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype and np.array_equal(g, w), f"{path}/{k}"
