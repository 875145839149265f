"""Classifier registry mirroring the reference's ``build_classifier``.

Only ShuffleNetV2 (the serving classifier) is ported so far; ResNet18,
MobileNetV2 and EfficientNet-B0 are ROADMAP item M10.
"""

from __future__ import annotations

from torch import nn

from litepi_tpu_torch.models.shufflenetv2 import ShuffleNetV2

# all four reference classifiers use torchvision's BatchNorm2d epsilon
CLASSIFIER_BN_EPS = 1e-5

NOT_PORTED = ("resnet18", "mobilenetv2", "efficientnet")


def build_classifier(arch: str, num_classes: int, fused: bool = False) -> nn.Module:
    """Instantiate a classifier by the reference's --clf_arch name.
    ``fused=True`` builds the deploy form (biased convs, BN pre-folded)."""
    if arch == "shufflenetv2":
        return ShuffleNetV2(num_classes=num_classes, fused=fused)
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"classifier {arch!r} is not ported yet (ROADMAP queue 1, M10)"
        )
    raise ValueError(
        f"unknown classifier arch {arch!r}; choices: "
        f"{sorted(('shufflenetv2',) + NOT_PORTED)}"
    )
