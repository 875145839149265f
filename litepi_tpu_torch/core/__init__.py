from litepi_tpu_torch.core.device import resolve_device
from litepi_tpu_torch.core.types import (
    DATASET_PRESETS,
    YOLO_PLUS_V1,
    YOLO_PLUS_V2,
    YOLOV8N,
    DetectorConfig,
    ablation_configs,
    NMSConfig,
    PipelineConfig,
    make_divisible,
    scale_depth,
)

__all__ = [
    "DATASET_PRESETS",
    "YOLO_PLUS_V1",
    "YOLO_PLUS_V2",
    "YOLOV8N",
    "DetectorConfig",
    "NMSConfig",
    "PipelineConfig",
    "ablation_configs",
    "make_divisible",
    "resolve_device",
    "scale_depth",
]
