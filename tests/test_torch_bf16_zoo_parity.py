"""The three zoo serving pairs in bfloat16, port against the JAX package on
the same variables: ``run_fused`` of YOLOv11n + ResNet18, YOLOv5n-u +
MobileNetV2 and the anchor-based YOLOv5n + EfficientNet-B0 (its candidate
decoder and capacity), each detector injected on both sides, so it runs
with its BatchNorm on letterboxed canvases x 1/255.

The detectors at full width on a 160 input, 10 classes, BatchNorm
statistics perturbed, the peaked 200x300 scene, as in
tests/test_torch_zoo_pipeline.py.  Discrete outputs must be equal, with the
conf threshold in a gap of the JAX bf16 candidate scores wider than both
score drifts and the labels' top-two gaps wider than the port's difference
(checked), as in tests/test_torch_bf16_parity.py.

Not every output meets the default pair's bound.  These deep nets (C3k2
and C2PSA, CSP, ResNet18, MobileNetV2, EfficientNet-B0 with BatchNorm)
round at every layer, and the two frameworks' convs sum in other orders,
so a few elements differ early and the difference spreads through the net
(tests/torch_bf16_layers.py localises it, layer by layer).  Where the JAX
program rounds otherwise than torch's ops, the port rounds as JAX: SiLU
and sigmoid at each of the five (four) bf16 steps JAX's StableHLO writes
(``ops/act.py``; the anchor-free YOLOv5n keeps torch's SiLU, see
``models/yolov5.py``), and ResNet18's and EfficientNet-B0's deploy-form
convs add their bias after the conv's output is rounded, as flax does.
Each float output of the valid slots is held within its bound where it
lies inside it, and otherwise within 1.2 times its measured ratio of the
port's difference to JAX's drift (floors 1e-6 scores, 1e-3 px boxes, 1e-5
probabilities); where a rounding brought an output inside, within 1.2 times
its new ratio (an output equal to JAX's, ratio 0, within the bound).
Measured ratios (``python -m tests.torch_bf16_layers --pairs``), with the
port's roundings, and before the SiLU / sigmoid rounding in brackets:
YOLOv11n + ResNet18 boxes 0.39 (0.93), scores 0 (1.43), probabilities 0.35,
cls scores 0.14; YOLOv5n-u + MobileNetV2 boxes and scores 0, probabilities
0.996, cls scores 1.12; anchor-based YOLOv5n + EfficientNet-B0 boxes 0.58
(1.64), scores 0.52 (2.48), probabilities 0.54 (0.81), cls scores 0.79
(1.02).  Outside the bound: MobileNetV2's cls scores.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litepi_tpu.models import build_classifier as jax_build_classifier
from litepi_tpu.models.init_utils import fast_init
from litepi_tpu.models.yolov5 import YoloV5 as JaxYoloV5
from litepi_tpu.models.yolov5 import v5_anchor_table, v5_candidates
from litepi_tpu.models.yolov11 import YoloV11 as JaxYoloV11
from litepi_tpu.pipeline import TwoStagePipeline as JaxPipeline
from litepi_tpu_torch.models import detector_kwargs
from litepi_tpu_torch.pipeline import TwoStagePipeline
from tests.test_torch_bf16_parity import (
    compare,
    conf_in_gap,
    jax_fused_scores,
    numpy_out,
    port_fused_scores,
)
from tests.test_torch_zoo_pipeline import ZOO
from tests.torch_port_helpers import (
    one_torch_thread,  # noqa: F401 (a fixture, used by pytestmark)
    peaked_frames,
    perturb_batchnorm,
    port_config,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (detector, classifier, extra config, detector seed, frames over the
# threshold, factors over the bound): random-init zoo detectors rank their
# candidates in bf16 steps (1e-5 to 2e-4 of score here), so each pair's seed
# and count put the threshold in a gap of the scores 4 to 9 times wider than
# both drifts; each factor is 1.2 times the output's measured ratio
PAIRS = {
    "v11_resnet18": ("yolov11n", "resnet18", dict(input_color="bgr"), 1, (1, 1),
                     dict(boxes=0.47, cls_probs=0.42, cls_scores=0.17)),
    "v5u_mobilenetv2": ("yolov5n", "mobilenetv2", {}, 3, (2, 2), dict(cls_scores=1.34)),
    "v5legacy_efficientnet": ("yolov5n_legacy", "efficientnet", {}, 4, (1, 1),
                              dict(boxes=0.70, det_scores=0.62, cls_probs=0.65,
                                   cls_scores=0.95)),
}


def _jax_pipeline(variant, cfg, det, clf, dtype):
    if variant == "yolov11n":
        jdet = JaxYoloV11(num_classes=1, dtype=dtype)
    else:
        jdet = JaxYoloV5(anchor_free=variant == "yolov5n", dtype=dtype)
    kw = {}
    if variant == "yolov5n_legacy":  # as litepi_tpu/apps/e2e.py wires it
        tables = [jnp.asarray(t) for t in v5_anchor_table(cfg.det_input_size)]
        kw = dict(candidate_decoder=lambda out, k: v5_candidates(out["pred"], *tables, k),
                  candidate_capacity=int(tables[0].shape[0]))
    return JaxPipeline(cfg, det, clf, dtype=dtype, det_model=jdet, **kw)


def run_pair(pair):
    """(port bf16, JAX bf16, JAX f32) ``run_fused`` outputs of a pair, at a
    threshold in a gap of the JAX bf16 candidate scores wider than both
    score drifts (checked)."""
    variant, arch, extra, seed, (min_above, max_above), _ = PAIRS[pair]
    cfg = dataclasses.replace(ZOO, classifier_arch=arch, **extra)
    jdet = JaxYoloV11(num_classes=1) if variant == "yolov11n" else JaxYoloV5(
        anchor_free=variant == "yolov5n")
    det = perturb_batchnorm(fast_init(jdet, seed=seed), seed=seed + 1)
    clf = perturb_batchnorm(
        fast_init(jax_build_classifier(arch, 10), seed=3, spatial=64), seed=4, spread=0.05)
    jf = _jax_pipeline(variant, cfg, det, clf, jnp.float32)
    jb = _jax_pipeline(variant, cfg, det, clf, jnp.bfloat16)
    pcfg = port_config(cfg)
    port = TwoStagePipeline.from_jax_vars(
        pcfg, det, clf, dtype=torch.bfloat16, device="cpu",
        **detector_kwargs(variant, pcfg, "cpu"))

    frames = peaked_frames()
    sb = jax_fused_scores(jb, frames)
    conf, half_gap, drift = conf_in_gap(sb, [jax_fused_scores(jf, frames),
                                             port_fused_scores(port, frames)],
                                        min_above, max_above)
    assert half_gap > drift, f"gap {2 * half_gap} not wider than the score drift {drift}"
    return (numpy_out(port.run_fused(frames, conf)), numpy_out(jb.run_fused(frames, conf)),
            numpy_out(jf.run_fused(frames, conf)))


@pytest.mark.parametrize("pair", list(PAIRS))
def test_zoo_run_fused_bf16_matches_jax_bf16(pair):
    compare(*run_pair(pair), PAIRS[pair][-1])


def test_biased_bf16_conv_rounds_as_flax():
    """ResNet18's deploy-form convs add their bias after the conv's own
    bf16 rounding (``layers.py::conv_bias_apart``), bit-equal to a biased
    bf16 flax ``nn.Conv``; a single rounding (torch's biased conv) is not."""
    from tests.torch_bf16_layers import op_checks

    shares = op_checks(n=256)
    assert shares["biased conv: bias apart"] == 0.0
    assert shares["biased conv: one rounding"] > 0.05
