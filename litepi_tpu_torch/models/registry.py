"""Classifier registry mirroring the reference's ``build_classifier`` (its
``--clf_arch`` names), and the zoo detectors by its ``--detector_variant``
names."""

from __future__ import annotations

from typing import Any, Callable, Dict

from torch import nn

from litepi_tpu_torch.core.types import PipelineConfig
from litepi_tpu_torch.models.efficientnet import EfficientNetB0
from litepi_tpu_torch.models.mobilenetv2 import MobileNetV2
from litepi_tpu_torch.models.resnet import ResNet18
from litepi_tpu_torch.models.shufflenetv2 import ShuffleNetV2
from litepi_tpu_torch.models.yolo12 import Yolo12L
from litepi_tpu_torch.models.yolov5 import V5CandidateDecoder, YoloV5
from litepi_tpu_torch.models.yolov9 import YoloV9E
from litepi_tpu_torch.models.yolov11 import YoloV11
from litepi_tpu_torch.models.yoloworld import YoloWorldV2L

CLASSIFIER_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    "shufflenetv2": ShuffleNetV2,
    "resnet18": ResNet18,
    "mobilenetv2": MobileNetV2,
    "efficientnet": EfficientNetB0,
}

def build_classifier(arch: str, num_classes: int, fused: bool = False) -> nn.Module:
    """Instantiate a classifier by the reference's --clf_arch name.
    ``fused=True`` builds the deploy form (biased convs, BN pre-folded)."""
    if arch not in CLASSIFIER_REGISTRY:
        raise ValueError(
            f"unknown classifier arch {arch!r}; choices: {sorted(CLASSIFIER_REGISTRY)}"
        )
    return CLASSIFIER_REGISTRY[arch](num_classes=num_classes, fused=fused)


DETECTOR_VARIANTS = ("yolov11n", "yolov5n", "yolov5n_legacy", "yolo12l", "yoloworldv2l",
                     "yolov9e")


def detector_kwargs(variant: str, cfg: PipelineConfig, device="cuda") -> Dict[str, Any]:
    """The ``TwoStagePipeline`` keyword arguments that inject a zoo detector
    for the pipeline configuration ``cfg``, as the JAX package's e2e app
    wires them: ``det_model`` (YOLOv11n, YOLO12-L, YOLO-World-v2-L with that
    many prompts folded in, YOLOv9-E (its RepConvs folded by the pipeline
    through ``YoloV9E.deploy_form``), or YOLOv5n anchor-free (the
    u-variant) or anchor-based) with ``cfg.detector.num_classes`` classes,
    and for the anchor-based head its ``candidate_decoder`` (anchor table
    for ``cfg.det_input_size``, made on ``device``) and
    ``candidate_capacity`` (3 x the anchor-free grid)."""
    num_classes = cfg.detector.num_classes
    if variant == "yolov11n":
        return {"det_model": YoloV11(num_classes=num_classes)}
    if variant == "yolo12l":
        return {"det_model": Yolo12L(num_classes=num_classes)}
    if variant == "yoloworldv2l":
        return {"det_model": YoloWorldV2L(num_classes=num_classes)}
    if variant == "yolov9e":
        return {"det_model": YoloV9E(num_classes=num_classes)}
    if variant == "yolov5n":
        return {"det_model": YoloV5(num_classes=num_classes, anchor_free=True)}
    if variant == "yolov5n_legacy":
        decoder = V5CandidateDecoder(cfg.det_input_size, device)
        return {"det_model": YoloV5(num_classes=num_classes), "candidate_decoder": decoder,
                "candidate_capacity": decoder.capacity}
    raise ValueError(f"unknown detector variant {variant!r}; choices: {DETECTOR_VARIANTS}")
