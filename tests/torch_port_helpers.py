"""Shared fixtures of the port's tests (``tests/test_torch_*.py``).

The JAX package is the reference: inputs are made with numpy from a seed
and go through the JAX function and its ``litepi_tpu_torch`` counterpart;
weights are made by the JAX package's own init and carried into the port
through ``litepi_tpu_torch.weights.jax_bridge``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

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
