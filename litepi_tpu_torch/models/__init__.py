from litepi_tpu_torch.models.efficientnet import EfficientNetB0
from litepi_tpu_torch.models.mobilenetv2 import MobileNetV2
from litepi_tpu_torch.models.registry import build_classifier, detector_kwargs
from litepi_tpu_torch.models.resnet import ResNet18
from litepi_tpu_torch.models.shufflenetv2 import ShuffleNetV2
from litepi_tpu_torch.models.yolo import YoloLitePi
from litepi_tpu_torch.models.yolo12 import Yolo12L
from litepi_tpu_torch.models.yolov5 import V5CandidateDecoder, YoloV5
from litepi_tpu_torch.models.yolov9 import YoloV9E
from litepi_tpu_torch.models.yolov11 import YoloV11
from litepi_tpu_torch.models.yoloworld import YoloWorldV2L

__all__ = [
    "EfficientNetB0",
    "MobileNetV2",
    "ResNet18",
    "ShuffleNetV2",
    "V5CandidateDecoder",
    "Yolo12L",
    "YoloLitePi",
    "YoloV5",
    "YoloV9E",
    "YoloV11",
    "YoloWorldV2L",
    "build_classifier",
    "detector_kwargs",
]
