"""Hand-written CUDA kernels of the port and their launch counts.

Each wrapper adds one to its entry in :data:`LAUNCHES` where it launches
its kernel, and nowhere else, so a run can show which kernels its path
went through.  The wrappers live in ``kernels/nms.py``, ``kernels/roi.py``,
``kernels/stem.py``, ``kernels/act.py`` and ``kernels/vocab.py``; the
sources in ``csrc/``.
``area_attn`` and ``maxsig`` count the calls of a model's core instead
(``models/yolo12.py::area_attention``, ``models/yoloworld.py::
max_sigmoid_attention``), and ``cbfuse`` the calls of YOLOv9-E's fan-in
(``models/yolov9.py::cbfuse``).
"""

from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {
    "nms_suppress": 0,
    "nms_greedy_cluster": 0,  # the calls of nms_suppress whose greedy pass ran on a cluster
    "roi_crop_dense": 0,
    "roi_crop_pyramid": 0,
    "roi_crop_pyramid_bf16": 0,
    "stem": 0,
    "silu_bf16": 0,
    "silu_bias_bf16": 0,  # the bias mode: a biased conv's bias add folded into the SiLU
    # the BatchNorm mode: an eval BatchNorm with the SiLU after it, or alone
    "bn_silu_bf16": 0,
    "bn_bf16": 0,
    "sigmoid_bf16": 0,
    "silu_bf16_bwd": 0,
    "sigmoid_bf16_bwd": 0,
    # YOLO12's area-attention cores (models/yolo12.py): SDPA's flash kernel
    # on the card in bf16, the plain version elsewhere; 16 per YOLO12-L call
    "area_attn": 0,
    # YOLO-World's max-sigmoid text attention cores (models/yoloworld.py):
    # chunked products on the card in bf16, the plain version elsewhere;
    # 4 per YOLO-World-v2-L call
    "maxsig": 0,
    # YOLO-World's class head (models/yoloworld.py::world_head): one GEMM per
    # level in bf16 on the card; 3 per YOLO-World-v2-L call there
    "vocab_gemm": 0,
    # YOLOv9-E's CBFuse fan-ins (models/yolov9.py::cbfuse): broadcast adds
    # into one output map, in any dtype; 5 per YOLOv9-E call
    "cbfuse": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)
