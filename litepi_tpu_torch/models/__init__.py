from litepi_tpu_torch.models.registry import build_classifier
from litepi_tpu_torch.models.shufflenetv2 import ShuffleNetV2
from litepi_tpu_torch.models.yolo import YoloLitePi

__all__ = ["ShuffleNetV2", "YoloLitePi", "build_classifier"]
