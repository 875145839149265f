"""The port's metric oracles: numpy copies of the JAX package's
``litepi_tpu/evals`` (labels, Ultralytics-contract mAP, the reference-exact
evaluator, the level-0 evaluator), with the same names."""

from litepi_tpu_torch.evals.labels import (
    parse_yolo_label,
    load_class_names,
    sample_images,
)
from litepi_tpu_torch.evals.map import evaluate_predictions, match_predictions
from litepi_tpu_torch.evals.reference import (
    compute_ap_reference,
    evaluate_predictions_reference,
    match_predictions_reference,
)

__all__ = [
    "parse_yolo_label",
    "load_class_names",
    "sample_images",
    "evaluate_predictions",
    "match_predictions",
    "compute_ap_reference",
    "evaluate_predictions_reference",
    "match_predictions_reference",
]
