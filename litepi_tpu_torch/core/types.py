"""Typed configuration, copied from the JAX package's ``core/types.py``.

The port keeps its own copy so that it imports nothing of ``litepi_tpu``;
``tests/test_torch_ops.py`` holds every dataclass and preset here equal to
the JAX copy (``dataclasses.asdict``), so the two cannot drift.

Field meanings are the JAX package's.  Where a field selects a TPU-only
behaviour, the comment says what the port does with it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


def make_divisible(x: float, divisor: int = 8) -> int:
    """Round channel count up to the nearest multiple of ``divisor``
    (the shipped yolo_plus_v2 stem is 16 wide: 48 * 0.25 = 12 rounds up)."""
    return int(math.ceil(x / divisor) * divisor)


def scale_depth(n: int, depth: float) -> int:
    """Scale a block-repeat count, never below one repeat."""
    return max(round(n * depth), 1)


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Architecture hyper-parameters for the YOLO-LitePi detector family.

    ``base_channels`` are the pre-scale stage widths (stem..P5) and
    ``base_depths`` the pre-scale C2f repeat counts; effective widths are
    ``make_divisible(base * width)``.  ``reg_max=16`` matches the exported
    reference graphs.
    """

    name: str = "yolo_plus_v2"
    num_classes: int = 1
    base_channels: Tuple[int, ...] = (48, 96, 192, 384, 768)
    base_depths: Tuple[int, ...] = (3, 6, 6, 3)
    width: float = 0.25
    depth: float = 0.33
    reg_max: int = 16
    input_size: int = 640
    strides: Tuple[int, ...] = (8, 16, 32)
    # PAN bottom-up down-conv widths (pre-scale).  None = the stock YOLOv8
    # pattern (base P3, P4) that yolo_plus_v2 follows; yolo_plus_v1 widens
    # each down conv to the NEXT stage width.
    neck_down_base: Optional[Tuple[int, int]] = None
    # yolo_plus runs residual bottlenecks in the neck C2fs too; stock
    # YOLOv8 necks do not.
    neck_shortcut: bool = True

    @property
    def channels(self) -> Tuple[int, ...]:
        return tuple(make_divisible(c * self.width) for c in self.base_channels)

    @property
    def depths(self) -> Tuple[int, ...]:
        return tuple(scale_depth(n, self.depth) for n in self.base_depths)

    @property
    def num_anchors(self) -> int:
        return sum((self.input_size // s) ** 2 for s in self.strides)

    @property
    def reg_channels(self) -> int:
        """Width of the Detect head's box branch: max(16, P3/4, 4*reg_max)."""
        return max(16, self.channels[2] // 4, 4 * self.reg_max)

    @property
    def cls_channels(self) -> int:
        """Width of the Detect head's class branch: max(P3, min(nc, 100))."""
        return max(self.channels[2], min(self.num_classes, 100))

    @property
    def neck_down_channels(self) -> Tuple[int, int]:
        """Scaled widths of the two PAN bottom-up down convs."""
        base = self.neck_down_base or (
            self.base_channels[2], self.base_channels[3]
        )
        return tuple(make_divisible(c * self.width) for c in base)


# The shipped TT100K detector: stem 16 -> 24 -> 48 -> 96 -> 192, C2f x(1,2,2,1).
YOLO_PLUS_V2 = DetectorConfig(name="yolo_plus_v2")

# The shipped VN-Signs detector: half width, PAN down convs widened to the
# next stage width.
YOLO_PLUS_V1 = DetectorConfig(
    name="yolo_plus_v1",
    base_channels=(32, 64, 128, 256, 512),
    neck_down_base=(256, 512),
)

# Stock YOLOv8n widths; stock v8 necks run plain (non-residual) bottlenecks.
YOLOV8N = DetectorConfig(
    name="yolov8n",
    base_channels=(64, 128, 256, 512, 1024),
    neck_shortcut=False,
)

# Dataset presets: classifier crop-normalisation stats, class counts and
# the detector each dataset ships.
DATASET_PRESETS = {
    "tt100k": {
        "num_classes": 91,
        "detector_variant": "yolo_plus_v2",
        "cls_mean": (0.18, 0.18, 0.18),
        "cls_std": (0.34, 0.34, 0.34),
    },
    "vntsr": {
        "num_classes": 49,
        "detector_variant": "yolo_plus_v1",
        "cls_mean": (0.4280886, 0.37681347, 0.442565),
        "cls_std": (0.1980449, 0.18132778, 0.19366477),
    },
}



def ablation_configs(
    width_scales=(0.5, 0.75, 1.0),
    depth_scales=(0.33,),
    extra=((0.75, 0.67),),
    num_classes: int = 1,
) -> Tuple[DetectorConfig, ...]:
    """The width/depth ablation grid (the reference's config generator:
    w in {0.5, 0.75, 1.0} x d 0.33 plus (0.75, 0.67); w0.75 / d0.33 is
    YOLO-LitePi): variant w scales the v8 base stage widths (w=0.75 gives
    yolo_plus_v2's 48/96/192/384/768), then the 0.25 width multiple
    applies.  The training CLI's ``--width_scale`` / ``--depth_scale``."""
    combos = [(w, d) for d in depth_scales for w in width_scales]
    combos += [c for c in extra if c not in combos]
    return tuple(
        DetectorConfig(
            name=f"ablation_w{w:g}_d{d:g}",
            num_classes=num_classes,
            base_channels=tuple(
                int(round(c * w)) for c in (64, 128, 256, 512, 1024)
            ),
            width=0.25,
            depth=d,
        )
        for w, d in combos
    )

@dataclasses.dataclass(frozen=True)
class NMSConfig:
    """Fixed-shape postprocess contract: keep the top ``max_candidates``
    scores, suppress greedily per class, emit exactly ``max_detections``
    padded slots per image."""

    conf_threshold: float = 0.25
    iou_threshold: float = 0.45
    max_candidates: int = 512
    max_detections: int = 64
    min_area: float = 50.0  # pixel-area floor for ROI crops
    # budgets of the low-conf mAP pass (0 = unbounded; host NMS)
    eval_max_candidates: int = 0
    eval_max_detections: int = 0


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end two-stage pipeline configuration."""

    detector: DetectorConfig = YOLO_PLUS_V2
    nms: NMSConfig = NMSConfig()
    classifier_arch: str = "shufflenetv2"
    num_classifier_classes: int = 91  # TT100K crops; VN-Signs uses 49
    det_input_size: int = 640
    cls_input_size: int = 64
    batch_size: int = 8
    yolo_conf: float = 0.001
    benchmark_conf: float = 0.25
    cls_mean: Tuple[float, float, float] = (0.18, 0.18, 0.18)
    cls_std: Tuple[float, float, float] = (0.34, 0.34, 0.34)
    # the port takes its compute dtype as a constructor argument instead
    compute_dtype: str = "bfloat16"
    # ROI crop of the fused path.  In the port "dense" is the ROI kernel's
    # exact 2-tap mode (any box size), "pallas" its 4^k pyramid mode and
    # "windowed" the JAX package's windowed crop (stock torch, ``roi_window``
    # wide; the dense crop on frames no larger than the window).
    roi_impl: str = "dense"
    roi_window: int = 128
    # images per sequential step of the JAX dense crop: a TPU loop-shape
    # knob that the port accepts and ignores
    roi_chunk: int = 8
    # candidate top-k selector: "exact" (stable sort, ties to the lower
    # index) or "approx" (a TPU primitive; the port routes it to "exact")
    candidate_selector: str = "exact"
    # colour order of host frames; model compute is always RGB
    input_color: str = "rgb"
    # per-frame crop budget: keep the top ``crop_det_budget`` NMS slots per
    # frame before the ROI crop (0 = all ``max_detections`` slots)
    crop_det_budget: int = 0
    # global classifier budget: classify only the top ``cls_crop_budget``
    # crops by detection score across the batch (0 = every slot); slots
    # beyond it lose their valid bit
    cls_crop_budget: int = 0
