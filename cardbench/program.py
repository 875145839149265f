"""The system under test: the port's ``TwoStagePipeline`` built from a
configuration file through the port's public constructor.  The only module of the benchmark that
imports the port.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def pipeline_config(config: dict, batch: int):
    """The port's ``PipelineConfig`` for ``config`` at a global batch of
    ``batch`` frames (the classifier budget scales with it)."""
    from litepi_tpu_torch.core.types import DetectorConfig, NMSConfig, PipelineConfig

    det, cls, sv = config["detector"], config["classifier"], config["serving"]
    detector = DetectorConfig(
        name=det.get("port_name", "yolo_plus_v2"), num_classes=det["num_classes"],
        base_channels=tuple(det["base_channels"]),
        base_depths=tuple(det.get("base_depths", (3, 6, 6, 3))),
        width=det["width"], depth=det["depth"], reg_max=det["reg_max"],
        input_size=det["input_size"], strides=tuple(det["strides"]))
    nms = NMSConfig(conf_threshold=sv["conf_threshold"], iou_threshold=sv["iou_threshold"],
                    max_candidates=sv["max_candidates"], max_detections=sv["max_detections"],
                    min_area=sv["min_area"])
    return PipelineConfig(
        detector=detector, nms=nms, classifier_arch=cls["arch"],
        num_classifier_classes=cls["num_classes"], det_input_size=det["input_size"],
        cls_input_size=cls["input_size"], benchmark_conf=sv["conf_threshold"],
        cls_mean=tuple(cls["mean"]), cls_std=tuple(cls["std"]), input_color=sv["input_color"],
        roi_impl=sv["roi_impl"], crop_det_budget=sv["crop_det_budget"],
        cls_crop_budget=sv["cls_crop_budget_per_frame"] * batch)


def build(config: dict, det_state, cls_state, batch: int, device) -> Callable:
    """``call(frames) -> outputs``: ``run_fused`` of a pipeline on the raw
    state dicts."""
    from litepi_tpu_torch.models.registry import detector_kwargs
    from litepi_tpu_torch.pipeline.two_stage import TwoStagePipeline

    cfg = pipeline_config(config, batch)
    variant = config["detector"].get("variant")
    zoo = detector_kwargs(variant, cfg, device) if variant else {}
    pipe = TwoStagePipeline(cfg, det_state, cls_state, dtype=DTYPES[config["serving"]["dtype"]],
                            device=device, **zoo)
    return pipe.run_fused


def launch_counts() -> Dict[str, int]:
    from litepi_tpu_torch.kernels import launch_counts as counts

    return counts()


def reset_launch_counts() -> None:
    from litepi_tpu_torch.kernels import reset_launch_counts as reset

    reset()


def build_kernels() -> None:
    """Build the port's CUDA kernels (once per checkout), so that set-up
    times the build apart from the program's constructor."""
    from litepi_tpu_torch.kernels import build as kbuild

    kbuild.build()
