"""Training: the detector and classifier train steps, their losses and
optimizers (the port's copy of the JAX package's ``litepi_tpu/train``)."""

from litepi_tpu_torch.train.classifier import (
    ClassifierTrainState,
    classifier_train_step,
    create_classifier_train_state,
)
from litepi_tpu_torch.train.detector import (
    DetectorTrainState,
    create_detector_train_state,
    detector_train_step,
)

__all__ = [
    "ClassifierTrainState",
    "DetectorTrainState",
    "classifier_train_step",
    "create_classifier_train_state",
    "create_detector_train_state",
    "detector_train_step",
]
