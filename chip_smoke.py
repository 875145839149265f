"""Drive the port's main path on one CUDA card and hold its kernels against
their plain versions.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``litepi_tpu_torch/csrc`` (one ``nvcc`` per
source, in parallel), then:

1. NMS kernel vs ``suppress_sorted`` on the same CUDA tensors: keep masks
   bit-equal at B=128 for K in {1, 63, 64, 65, 512, 1024} (both sides of
   the one-kernel bound at 64 and of a word edge) with 1, 3 and 91
   classes; timed at K=64 (the serving candidate budget) and K=512 (the
   NMSConfig default) on 1-class inputs, the serving detector's;
2. ROI crop kernel vs ``crop_and_resize_plain``, both modes on B=128, D=8,
   640x640 (the serving crop), on B=8, D=8, 1080x1920 (three pyramid
   levels) and on an all-invalid batch, both modes also with the bf16
   rounding a bf16 pipeline's crop runs (tap weights and y-lerps rounded
   to bf16 values, as the JAX bf16 dense crop and the Pallas kernel
   round); dense timed on both sizes (beside ``F.grid_sample``; the bf16
   rounding at the serving size), pyramid on the second in both roundings,
   alone and, for float32, with the level build the main path runs;
   tolerance 1e-3 on 0-255 values (both round each f32 product and sum
   once, in the same order; 0 is expected);
3. stem kernel vs ``stem_plain`` on B=128 640x640 C=16 (the serving stem),
   B=2 160x240 C=32, and the tile and pair edges: H in {2, 6, 80}, W in
   {2, 10, 642} (642: an odd output width), C in {16, 32} (weights as
   kernel parameters) and {3, 20, 256} (the generic path), on random,
   all-0 and all-255 frames: float32 out within 1e-4 (the tolerance
   tests/test_pallas_stem.py holds the Pallas kernel to), bfloat16 out
   within one bf16 ulp (1e-5 below 2^-10, where float32 sum noise is
   larger than an ulp; bit-equal expected: in bf16 both round the conv,
   the bias and SiLU's five steps alike); the serving shape timed, beside
   the cuDNN stem it replaces (conv + bias + SiLU on the bf16 canvas); the
   bf16 SiLU / sigmoid kernel (``csrc/act.cu``, port-only) against its
   plain version (five / four torch passes) within one bf16 ulp at
   ACT_CASES and the timed shapes, beside the plain passes and torch's
   one-pass op;
4. the small pipeline (narrow detector, 10-class classifier, float32, TF32
   off) on the card vs the same pipeline on the CPU, where the kernels'
   plain versions run, at 200x300 frames (letterboxed) and at 160x160
   (canvas-sized: the stem kernel runs); then the same check for two zoo
   pairs at a 160 input, the detectors at full width: YOLOv11n + ResNet18
   and the anchor-based YOLOv5n + EfficientNet-B0 (its candidate decoder),
   with the stem kernel never launched;
5. the main path: ``TwoStagePipeline.run_fused`` at the full width of
   yolo_plus_v2 + ShuffleNetV2-91 in bfloat16 with the serving
   configuration (64 candidates, 16 detections, crop_det_budget 8,
   cls_crop_budget 4*B, BGR frames): B=128 at 640x640 (the stem kernel's
   path) and B=8 at 1080x1920, then B=8 at 1080x1920 with the pyramid
   crop, and that once more in float32 (the pyramid mode without bf16
   rounding), each on device frames and a device ``area_scale`` under
   ``torch.cuda.set_sync_debug_mode("error")``, so any host
   synchronisation fails the run.  Launch counts are zeroed just before
   each run and read just after; every kernel must have run, the pyramid
   crop in both roundings;
6. the staged ``detect`` at full width with the default NMSConfig (512
   candidates, 64 detections) on B=32 640x640 [0, 1] canvases, the path
   that runs the NMS kernel at K=512: issued under the same sync check,
   the NMS kernel launched once, outputs equal to ``nms_sorted`` over the
   same candidates with the plain keep mask;
7. streaming: ``StreamingRunner.run`` over 12 batches of B=128 640x640
   letterboxed canvases of a 1080x1920 source (3 distinct batches made
   from a seed, cycled), inflight 2, each batch equal to a direct
   ``run_fused`` + host unmap of the same canvases; frames/s beside the
   device-only ``run_fused`` and ``benchmark_ram``;
8. the zoo: ``run_fused`` with an injected detector (``det_model``, BN kept,
   letterbox + x 1/255 + BGR flip, no stem kernel) at the serving
   configuration in bfloat16 on device frames: YOLOv11n + ResNet18-91 at
   B=128 640x640, then YOLOv5n (anchor-free) + MobileNetV2-91 and the
   anchor-based YOLOv5n + EfficientNet-B0-91 (``V5CandidateDecoder``,
   capacity 25,200) at B=32, weights from ``torch.Generator`` seeds.  Each
   run is issued under ``set_sync_debug_mode("error")`` with the launch
   counts zeroed just before and read just after: the NMS and dense ROI
   kernels once each, the stem kernel and the pyramid crop never; outputs
   checked as the main path's, with at least one valid detection; the NMS
   kernel bit-equal to ``suppress_sorted`` and the dense crop within
   ROI_TOL of the plain crop on the run's own candidates and boxes (B=32,
   D=8 is a row-band split the kernel checks do not reach); ms/batch
   and FPS from 5 windows of 20 batches, and the host's time to issue one
   batch (near ms/batch, the run is host-bound); the NMS and ROI kernels' device
   time inside the YOLOv11n run; and the anchor-based detector's
   ``detect_candidates`` at ``eval_max_candidates=0`` (25,200 candidates
   per image, score-descending, sync-free);
9. the evaluation core: ``PipelineEvaluator`` (frames served from memory
   through ``_read_image``) on the card vs on the CPU with SMALL's float32
   pipeline (TF32 off) on 5 frames of 200x300 and 300x200 at batch 2 (a
   trailing partial batch), the thresholds in gaps of the candidate scores
   20x the card-vs-CPU noise wide: ``run_images`` with and without
   ``eval_budget`` per image (counts equal, boxes 1e-3 px, det scores
   1e-6, labels exact, cls scores 1e-5) and the reference metric row within
   1e-6; then ``evaluate_dataset(metrics_mode="reference")`` at the e2e
   app's defaults (yolo_plus_v2 + ShuffleNetV2-91, 640, B=8, float32,
   dense, 512 candidates, 8,400 per image in the mAP pass, yolo_conf
   0.001, benchmark_conf 0.25) over 32 random 2048x2048 frames, printing
   its FPS, stage times, each pass's seconds, the metric row and the
   launch counts (zeroed just before, read just after: the NMS kernel at
   least once, the dense crop at least 4 times, the stem kernel and the
   pyramid crop never), then the NMS and dense ROI kernels against their
   plain versions on that run's first batch (bit-equal at K=512, B=8;
   within 1e-3 on the 2048x2048 frames);
10. the e2e CLI (``apps/e2e.py::main``, in this process) on deployed
   artifacts written on the card with torch only: an Ultralytics training
   container of the YOLOv8 mirror (``tests/torch_yolo_ref.py``) at
   yolo_plus_v2's widths, read back through the stub unpickler (each value
   the source's fp16 rounding), its imported head outputs (float32, TF32
   off) against the mirror's own forward within 1e-4 of their largest
   magnitude, and a torchvision ShuffleNetV2-91 ``.pth``; the CLI with
   ``--device cuda`` and ``--device cpu`` at ``--det_input_size 160
   --num_samples 2`` on JPEG frames, the thresholds in score gaps as in
   phase 9, metric rows and per-class rows within 1e-6; then at its
   defaults (yolo_plus_v2 + ShuffleNetV2-91, 640, B=8, float32, dense, 512
   candidates) and in bf16 with ``--roi_impl pallas`` on 32 2048x2048 JPEG
   frames from disk, each with its launch counts zeroed just before and
   read just after (the NMS kernel at least once; the dense crop at least
   4 times in the float32 run, the pyramid crop's bf16 mode at least once
   in the bf16 run, the other crops never; the stem kernel never) and its
   output files checked; wall seconds and the fused pass's FPS printed;
   then, in a pipeline built as the CLI builds its own, the NMS kernel
   and the crop in the run's mode and rounding against their plain
   versions on the inputs of the fused pass's first batch (in the bf16
   run the pyramid at B=8, D=64 over 4 levels of 2048x2048 frames).  The
   full-width frames' labels come from the artifacts' own detections at
   ``benchmark_conf``, jittered, so that the metric rows are neither 0
   nor 1;
11. the convert phase, the reverse path, from phase 10's artifacts and
   frames: the convert CLI (``apps/convert.py::main``, ``--device cuda``)
   emits the detector at 640 as NCNN (fp32 and fp16), ONNX and OpenVINO,
   the classifier in all three, and writes the default checkpoint, each
   with rc 0; each emitted graph runs through the port's interpreter of
   its format on the card and on the CPU (float32, TF32 off), the two
   within GRAPH_TOL of each other and the card's within GRAPH_TOL of the
   port's model holding the graph's weights (plus the DFL decode); the e2e
   CLI at its defaults over the emitted fp32 NCNN pairs, its metric row
   within ROW_TOL of phase 10's float32 run, its launches counted, K1 and
   K2 against their plain versions on its first batch; last, the exported
   programs (``export_classifier`` at 64, ``export_detector`` at 640)
   against eager within PROGRAM_TOL.  The bf16 SiLU / sigmoid kernel is
   held against its plain version with the kernel checks (step 3).

Prints the build's resource report (``-Xptxas -v``: registers and spills
per kernel) and the card's ``nvidia-smi`` name and power limit before the
checks and again after the timed phases, a ``{"kernels": [...]}`` JSON
line (``ms`` from CUDA events after warm-up, the median of 5 windows;
``device_ms`` the mean duration of the kernel itself from
``torch.profiler``'s CUDA activity over as many launches as one window,
traced apart from the timed windows, summed over the kernels of one call
(K1 above K=64 runs two); ``host_ms``
the host's time to issue one call, so that where ``host_ms`` is near
``ms`` the window timed the host and ``device_ms`` is the kernel's time;
bounds from this run's inputs against the H100 SXM's published 3.35 TB/s
and 67 TFLOP/s float32; ``eval_launches`` the eval phase's full-width
launches on the entry of their shape, ``e2e_cli_launches`` the e2e CLI
phase's, ``convert_launches`` the convert phase's), an ``{"e2e": ...,
"zoo": ..., "eval": ..., "e2e_cli": ..., "convert": ...}`` JSON line, and
last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero.
Exits non-zero without a result when no CUDA device is present.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from litepi_tpu_torch.apps import convert as convert_cli
from litepi_tpu_torch.apps import e2e as e2e_cli
from litepi_tpu_torch.core.types import (
    YOLO_PLUS_V2,
    YOLOV8N,
    DetectorConfig,
    NMSConfig,
    PipelineConfig,
)
from litepi_tpu_torch.data import native_loader
from litepi_tpu_torch.evals.labels import sample_images
from litepi_tpu_torch.kernels import build as kbuild
from litepi_tpu_torch.kernels import launch_counts, reset_launch_counts
from litepi_tpu_torch.kernels.nms import nms_suppress_cuda
from litepi_tpu_torch.kernels.roi import roi_crop_cuda
from litepi_tpu_torch.kernels.stem import pack_stem_params, stem_cuda
from litepi_tpu_torch.models import YoloLitePi, build_classifier, detector_kwargs
from litepi_tpu_torch.ops import act as act_ops
from litepi_tpu_torch.ops.letterbox import letterbox_params
from litepi_tpu_torch.ops import nms as nms_ops
from litepi_tpu_torch.ops.nms import suppress_sorted
from litepi_tpu_torch.ops.roi import (
    EXACT_EXTENT,
    build_pyramid,
    crop_and_resize_plain,
    crop_and_resize_pyramid,
    pyramid_scales,
    roi_geometry,
)
from litepi_tpu_torch.ops.stem import fused_stem, stem_plain
from litepi_tpu_torch.pipeline import PipelineEvaluator, StreamingRunner, TwoStagePipeline
from litepi_tpu_torch.pipeline.streaming import area_scale_of, unmap_boxes
from litepi_tpu_torch.tools.nms_ab import nms_inputs
from litepi_tpu_torch.tools.roi_ab import roi_inputs, touched_bytes
from litepi_tpu_torch.tools.stage_split import (
    cuda_ms,
    cuda_ms_windows,
    kernel_device_ms,
    kernel_device_times,
)
from litepi_tpu_torch.weights import ncnn_import, onnx_import, openvino_import
from litepi_tpu_torch.weights.export import export_classifier, export_detector, load_program
from litepi_tpu_torch.weights.graph_ops import float32_exact
from litepi_tpu_torch.weights.jax_bridge import jax_to_state_dict
from litepi_tpu_torch.weights.onnx_import import defuse_state_dict
from litepi_tpu_torch.weights.seeded import seeded_state
from litepi_tpu_torch.weights.torch_import import (
    convert_classifier_state_dict,
    convert_detector_state_dict,
    load_torch_state_dict,
)

def load_test_module(name: str):
    """The torch-only module ``tests/<name>.py`` of this checkout, loaded
    by its path: a machine may have another package named ``tests``
    installed, which ``import tests...`` would find first."""
    mod_name = f"litepi_tests_{name}"
    if mod_name not in sys.modules:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", f"{name}.py")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        sys.modules[mod_name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[mod_name])
    return sys.modules[mod_name]


HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores, published
ROI_TOL = 1e-3

NMS_BATCH, NMS_KS = 128, (64, 512)  # timed: serving K, and the NMSConfig default
NMS_EQUAL_KS = (1, 63, 64, 65, 512, 1024)  # both sides of the one-kernel bound and a word edge
NMS_CLASSES = (1, 3, 91)
ROI_DENSE = (128, 8, 640, 640)  # B, D, H, W of the serving crop
ROI_PYRAMID = (8, 8, 1080, 1920)
STEM_CASES = ((128, 640, 640, 16), (2, 160, 240, 32))  # B, H, W, C; serving first
# tile and pair edges of the stem kernel (B=2): heights, widths, channel
# counts (16 and 32 the parameter path, the rest the generic one), frames
STEM_EDGE_H, STEM_EDGE_W = (2, 6, 80), (2, 10, 642)
STEM_EDGE_C = (16, 32, 3, 20, 256)
STEM_EDGE_FILLS = ("random", 0, 255)
STEM_TOL = 1e-4
# the bf16 SiLU / sigmoid kernel: the default detector's down1 output at the
# serving B=128 (SiLU) and EfficientNet-B0's first squeeze-excite gate over
# the zoo run's 4*B=128 crops (sigmoid), timed; and the vector path, the
# scalar tail and an odd shape checked
ACT_SILU_SHAPE, ACT_SIGMOID_SHAPE = (128, 32, 160, 160), (128, 96, 1, 1)
ACT_CASES = ((2, 32, 40, 40), (1001,), (3, 20, 7, 9))
# small pipeline scenes (seed, H, W): letterboxed, and canvas-sized for SMALL
# (the stem kernel's branch); each seed's frames have top candidate scores
# more than 20x the card-vs-CPU noise apart under SMALL's seed-3 weights
SMALL_SCENES = ((11, 200, 300), (44, 160, 160))
# (B, H, W, roi_impl, dtype): the serving path in bf16, and the pyramid crop
# also in float32 (the ROI kernel's pyramid mode without bf16 rounding)
MAIN_RUNS = ((128, 640, 640, "dense", torch.bfloat16), (8, 1080, 1920, "dense", torch.bfloat16),
             (8, 1080, 1920, "pallas", torch.bfloat16), (8, 1080, 1920, "pallas", torch.float32))
DETECT_BATCH = 32  # the staged detect at K=512; B=32 keeps the phase short
STREAM_BATCH, STREAM_BATCHES, STREAM_DISTINCT = 128, 12, 3
STREAM_SOURCE = (1080, 1920)  # the canvases' source frame: ratio 1/3, dh 140
WINDOWS = 5  # back-to-back timing windows per kernel and per e2e run; the
# median is reported, every window is printed
# the zoo: (detector variant, classifier arch, batch) at 640x640, bf16
ZOO_RUNS = (("yolov11n", "resnet18", 128), ("yolov5n", "mobilenetv2", 32),
            ("yolov5n_legacy", "efficientnet", 32))
ZOO_SMALL_PAIRS = (("yolov11n", "resnet18"), ("yolov5n_legacy", "efficientnet"))
# conv and linear weights N(0, gain^2 / fan_in): with BatchNorm at its
# identity init, lecun's gain 1 lets the zoo detectors' signal fade to
# scores within 1e-6 of each other, 1.4 saturates the anchor-based head's;
# at 1.3 the top candidates of SMALL_SCENES lie 1e-5 to 1e-2 apart
ZOO_GAIN = 1.3

SERVING = PipelineConfig(
    nms=NMSConfig(max_candidates=64, max_detections=16),
    input_color="bgr",
    crop_det_budget=8,
    candidate_selector="exact",
)
SMALL = PipelineConfig(
    detector=DetectorConfig(
        name="tiny", base_channels=(32, 64, 128, 256, 512), input_size=160
    ),
    nms=NMSConfig(max_candidates=128, max_detections=8, min_area=4.0),
    num_classifier_classes=10,
    det_input_size=160,
)
# the zoo detectors at full width on SMALL's 160 input
ZOO_SMALL = dataclasses.replace(SMALL, detector=dataclasses.replace(YOLOV8N, input_size=160))
# e2e.py's detector config for the zoo variants (1 class, reg_max 16)
ZOO_SERVING = dataclasses.replace(SERVING, detector=YOLOV8N)
# the evaluation core: small card-vs-CPU frames (h, w) at batch 2 (landscape,
# portrait, a trailing partial batch), and the e2e app's defaults at full
# width (PipelineConfig's: yolo_plus_v2 + ShuffleNetV2-91, 640, B=8, dense,
# 512 candidates, every anchor in the mAP pass) on TT100K-sized frames
EVAL_SMALL_SIZES = ((200, 300), (200, 300), (300, 200), (300, 200), (200, 300))
EVAL_FULL = PipelineConfig(input_color="bgr")
EVAL_FULL_FRAMES, EVAL_FULL_SIZE = 32, 2048
# the e2e CLI phase: JPEG frames (h, w) of the card-vs-CPU run at a 160
# input (the CLI samples 2), the full-width runs' frames from disk, and the
# imported detector's tolerance against its torch source, relative to the
# outputs' largest magnitude (the BN fold in float32: ~1e-6 measured on the
# CPU)
E2E_CLI_SMALL_FRAMES = ((200, 320), (240, 320), (320, 200))
E2E_CLI_FULL_FRAMES, E2E_CLI_FULL_SIZE = 32, 2048
ARTIFACT_TOL = 1e-4
CLI_METRICS = ("mean_precision", "mean_recall", "mean_f1", "mAP50", "mAP50-95")
# the convert phase: emitted graphs through their interpreters on the card
# vs the CPU and vs the port's model plus decode (float32, TF32 off),
# relative to each part's largest magnitude (boxes, scores, logits); the
# e2e run over the emitted NCNN pairs against the .pt/.pth run's metric
# row; the exported programs against eager, relative
GRAPH_TOL, ROW_TOL, PROGRAM_TOL = 1e-4, 1e-6, 1e-5


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def bound(n_bytes: float, n_flops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def median_ms(fn, iters: int, warmup: int = 3):
    """(median, windows) of :func:`cuda_ms_windows` over WINDOWS windows."""
    ms = cuda_ms_windows(fn, iters, WINDOWS, warmup)
    return sorted(ms)[len(ms) // 2], ms


def host_ms(fn, iters: int) -> float:
    """Host milliseconds per call to issue ``fn`` back to back, without
    waiting for the card.  Near the CUDA-event time, the host's issue rate
    is what the event window measured."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def build_kernels() -> dict:
    t0 = time.perf_counter()
    paths = kbuild.build()
    print(f"built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    return paths


def print_resources(paths: dict, smi: str, when: str) -> None:
    """Each kernel's ``-Xptxas -v`` lines (entry, registers, spills) and the
    card's name and power limit."""
    print(f"--- kernel resources and card, {when}")
    for name, path in sorted(paths.items()):
        log = (path.parent / (path.name + ".log"))
        for line in log.read_text().splitlines() if log.exists() else []:
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    print(f"  nvidia-smi: {smi}")


def device_ms(fn, iters: int, name: str) -> float:
    """:func:`kernel_device_ms`, device time per call summed over the
    call's kernels; the trace may drop a few launches (it has shown 87 of
    100), so it fails only when it saw under half of the calls."""
    ms, seen = kernel_device_ms(fn, iters, name)
    if seen < iters // 2:
        fail(f"device time of {name}: the trace shows {seen} of {iters} calls")
    return ms


# --------------------------------------------------------------------- #
# NMS kernel                                                            #
# --------------------------------------------------------------------- #

def nms_bound(boxes, cls, valid):
    """(bound ms, by) of one call: boxes, cls and valid read once, keep
    written once; the operations this run's data needs, which are the
    pairs j < i with both candidates valid (an invalid one is never kept,
    so it suppresses nothing and its own bit is never read): one class
    compare each, an IoU (~14 operations) where the classes match, and 5
    per box for the areas."""
    b, k = valid.shape
    n_bytes = b * k * (16 + 4 + 1) + b * k
    pairs = valid[:, :, None] & valid[:, None, :] & torch.ones(
        k, k, dtype=torch.bool, device=valid.device).triu(1)
    same = int((pairs & (cls[:, :, None] == cls[:, None, :])).sum())
    return bound(n_bytes, int(pairs.sum()) + 14 * same + 5 * b * k)


def check_nms(dev):
    """Bit-equality at every K of NMS_EQUAL_KS and class count of
    NMS_CLASSES; the timed budgets NMS_KS on 1-class inputs (the serving
    detector's), the inputs ``tools/nms_ab.py`` times."""
    b, thr = NMS_BATCH, 0.45
    gen = torch.Generator(device=dev).manual_seed(0)
    timed = {k: nms_inputs(gen, b, k, 1, dev) for k in NMS_KS}
    n = 0
    for k in NMS_EQUAL_KS:
        for num_classes in NMS_CLASSES:
            boxes, cls, valid = (timed[k] if num_classes == 1 and k in timed
                                 else nms_inputs(gen, b, k, num_classes, dev))
            got = nms_suppress_cuda(boxes, cls, valid, thr)
            want = suppress_sorted(boxes, valid, cls, thr)
            torch.cuda.synchronize()
            mismatches = int((got != want).sum())
            if mismatches:
                fail(f"NMS kernel K={k}, {num_classes} classes: {mismatches} keep bits "
                     "differ from the plain version")
            if k > 1 and not (0 < int(got.sum()) < int(valid.sum())):
                fail(f"NMS check K={k}: inputs suppress nothing or keep nothing")
            n += 1
    print(f"nms: bit-equal to suppress_sorted in {n} cases (B={b}, K {NMS_EQUAL_KS}, "
          f"classes {NMS_CLASSES})")
    result = {}
    for k in NMS_KS:
        boxes, cls, valid = timed[k]
        kernel = lambda: nms_suppress_cuda(boxes, cls, valid, thr)  # noqa: E731
        ms, windows = median_ms(kernel, 200)
        plain_ms = cuda_ms(lambda: suppress_sorted(boxes, valid, cls, thr), 10, 1)
        host = host_ms(kernel, 200)
        dev_ms = device_ms(kernel, 200, "nms_")
        result[k] = dict(mismatches=0, ms=ms, windows=windows, host_ms=host,
                         device_ms=dev_ms, plain_ms=plain_ms, bound=nms_bound(boxes, cls, valid))
        print(f"nms K={k}, 1 class: kernel {ms:.4f} ms (windows {windows}), device "
              f"{dev_ms:.4f} ms, host issue {host:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{result[k]['bound'][0]:.5f} ms ({result[k]['bound'][1]})")
    return result


# --------------------------------------------------------------------- #
# ROI crop kernel                                                       #
# --------------------------------------------------------------------- #

def grid_for(boxes, h: int, w: int, out_size: int):
    """grid_sample grid (B, D*S, S, 2) at the crop's sample centres."""
    hw = [(h, w)]
    _, ys, ye, xs, xe, yl, xl = roi_geometry(boxes, hw, EXACT_EXTENT)
    o = torch.arange(out_size, dtype=torch.float32, device=boxes.device) + 0.5
    uy = (o * (ye / out_size)[..., None] - 0.5 + ys[..., None]).clamp(0, h - 1)
    ux = (o * (xe / out_size)[..., None] - 0.5 + xs[..., None]).clamp(0, w - 1)
    gy = (2 * uy + 1) / h - 1
    gx = (2 * ux + 1) / w - 1
    b, d = boxes.shape[:2]
    grid = torch.stack(
        [gx[..., None, :].expand(b, d, out_size, out_size),
         gy[..., :, None].expand(b, d, out_size, out_size)], -1
    )
    return grid.reshape(b, d * out_size, out_size, 2)


def roi_error(frames, boxes, valid, out_size: int, mode: str, round_bf16: bool = False):
    """The ROI kernel vs its plain version in one mode (with ``round_bf16``,
    the dense crop of a bf16 pipeline); returns (max abs error, kernel
    output, levels)."""
    h, w = int(frames.shape[1]), int(frames.shape[2])
    levels = [frames] if mode == "dense" else build_pyramid(frames, len(pyramid_scales(h, w)))
    got = roi_crop_cuda(levels, boxes, valid, out_size, EXACT_EXTENT, mode, round_bf16)
    want = crop_and_resize_plain(levels, boxes, valid, out_size, round_bf16=round_bf16)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    what = f"{mode}{', bf16 rounding' if round_bf16 else ''}"
    if not err <= ROI_TOL:
        fail(f"ROI kernel ({what}, {h}x{w}): max abs error {err} > {ROI_TOL}")
    return err, got, levels


def roi_timings(frames, boxes, valid, got, s: int) -> dict:
    """The dense kernel timed on these inputs (``got`` its output), beside
    its plain version and ``F.grid_sample`` on the same sample centres."""
    b, d = boxes.shape[:2]
    h, w = int(frames.shape[1]), int(frames.shape[2])
    kernel = lambda: roi_crop_cuda([frames], boxes, valid, s, EXACT_EXTENT, "dense")  # noqa: E731
    ms, windows = median_ms(kernel, 100)
    host = host_ms(kernel, 100)
    dev_ms = device_ms(kernel, 100, "roi_crop_kernel")
    plain_ms = cuda_ms(lambda: crop_and_resize_plain([frames], boxes, valid, s), 10, 1)
    x = frames.permute(0, 3, 1, 2).float().contiguous()
    grid = grid_for(boxes, h, w, s)
    lib = lambda: F.grid_sample(  # noqa: E731
        x, grid, mode="bilinear", padding_mode="border", align_corners=False
    )
    lib_out = lib().reshape(b, 3, d, s, s).permute(0, 2, 3, 4, 1)
    lib_err = float(((lib_out - got).abs() * valid[..., None, None, None]).max())
    library_ms = cuda_ms(lib, 20)
    n_valid_out = int(valid.sum()) * s * s * 3
    n_bytes = (touched_bytes([frames], boxes, valid, s) + boxes.numel() * 4 + valid.numel()
               + got.numel() * 4)
    return dict(ms=ms, windows=windows, host_ms=host, device_ms=dev_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_err=lib_err, bound=bound(n_bytes, 9 * n_valid_out))


def timing_text(r: dict) -> str:
    return (f"kernel {r['ms']:.4f} ms (windows {r['windows']}), device {r['device_ms']:.4f} ms, "
            f"host issue {r['host_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, grid_sample "
            f"{r['library_ms']:.4f} ms (max diff {r['library_err']:.3g}), bound "
            f"{r['bound'][0]:.5f} ms ({r['bound'][1]})")


def check_roi(dev):
    """Both modes on both frame sizes; the serving shape of each mode timed."""
    gen = torch.Generator(device=dev).manual_seed(1)
    s = 64
    result = {}

    # dense mode, the serving crop (pyramid mode checked on the same inputs)
    b, d, h, w = ROI_DENSE
    frames, boxes, valid = roi_inputs(gen, b, d, h, w, dev)
    err_pyr_640 = roi_error(frames, boxes, valid, s, "pyramid")[0]
    err_pyr_bf16_640 = roi_error(frames, boxes, valid, s, "pyramid", True)[0]
    err, got, _ = roi_error(frames, boxes, valid, s, "dense")
    result["dense"] = dict(err=err, **roi_timings(frames, boxes, valid, got, s))
    print(f"roi dense B={b} {h}x{w}: max err {err}, " + timing_text(result["dense"]))
    # the bf16 rounding mode, which a bf16 pipeline's dense crop runs
    err_bf16 = roi_error(frames, boxes, valid, s, "dense", True)[0]
    bf16_kernel = lambda: roi_crop_cuda([frames], boxes, valid, s, EXACT_EXTENT, "dense", True)  # noqa: E731
    result["dense"].update(bf16_err=err_bf16, bf16_ms=median_ms(bf16_kernel, 100)[0],
                           bf16_device_ms=device_ms(bf16_kernel, 100, "roi_crop_kernel"))
    print(f"roi dense B={b} {h}x{w} bf16 rounding: max err {err_bf16}, kernel "
          f"{result['dense']['bf16_ms']:.4f} ms, device {result['dense']['bf16_device_ms']:.4f} ms")

    # 1080x1920: dense mode (the B=8 dense main run's shape) checked and
    # timed beside grid_sample, then pyramid mode with levels 1/4, 1/16 and
    # 1/64 on the same inputs
    b, d, h, w = ROI_PYRAMID
    frames, boxes, valid = roi_inputs(gen, b, d, h, w, dev)
    err_b8, got, _ = roi_error(frames, boxes, valid, s, "dense")
    result["dense"]["err"] = max(result["dense"]["err"], err_b8)
    result["dense"]["bf16_err"] = max(result["dense"]["bf16_err"],
                                      roi_error(frames, boxes, valid, s, "dense", True)[0])
    result["dense_b8"] = roi_timings(frames, boxes, valid, got, s)
    print(f"roi dense B={b} {h}x{w}: max err {err_b8}, "
          + timing_text(result["dense_b8"]))
    err, got, levels = roi_error(frames, boxes, valid, s, "pyramid")
    err = max(err, err_pyr_640)
    # the kernel alone on levels built once, and the entry the main path
    # calls (plain-PyTorch level build + kernel)
    kernel = lambda: roi_crop_cuda(levels, boxes, valid, s, EXACT_EXTENT, "pyramid")  # noqa: E731
    ms, windows = median_ms(kernel, 100)
    host = host_ms(kernel, 100)
    dev_ms = device_ms(kernel, 100, "roi_crop_kernel")
    plain_ms = cuda_ms(lambda: crop_and_resize_plain(levels, boxes, valid, s), 10, 1)
    with_levels = lambda: crop_and_resize_pyramid(frames, boxes, valid, s)  # noqa: E731
    with_levels_ms, with_levels_windows = median_ms(with_levels, 100)
    # every kernel of the call (the level build's and K2), per call
    traced = kernel_device_times(with_levels, 100, "")
    with_levels_device_ms = sum(ms * n for ms, n in traced.values()) / 100
    n_valid_out = int(valid.sum()) * s * s * 3
    io_bytes = boxes.numel() * 4 + valid.numel() + got.numel() * 4
    n_bytes = touched_bytes(levels, boxes, valid, s) + io_bytes
    # the level build reads the frame once and writes each level once
    level_bytes = sum(l.numel() for l in levels)
    with_levels_bound = bound(level_bytes + io_bytes, frames.numel() + 9 * n_valid_out)
    result["pyramid"] = dict(err=err, ms=ms, windows=windows, host_ms=host, device_ms=dev_ms,
                             plain_ms=plain_ms,
                             levels=len(levels), bound=bound(n_bytes, 9 * n_valid_out),
                             with_levels_ms=with_levels_ms,
                             with_levels_windows=with_levels_windows,
                             with_levels_device_ms=with_levels_device_ms,
                             with_levels_bound=with_levels_bound)
    print(f"roi pyramid ({len(levels)} levels): max err {err}, kernel {ms:.4f} ms "
          f"(windows {windows}), device {dev_ms:.4f} ms, host issue {host:.4f} ms, plain "
          f"{plain_ms:.3f} ms, levels+kernel {with_levels_ms:.4f} ms (windows "
          f"{with_levels_windows}), device {with_levels_device_ms:.4f} ms in "
          f"{sum(n for _, n in traced.values()) / 100:.1f} kernels per call")
    # the bf16 rounding mode, which a bf16 pipeline's pyramid crop runs
    # (roi_impl="pallas"): the same levels and boxes, timed on its own
    err_bf16 = max(roi_error(frames, boxes, valid, s, "pyramid", True)[0], err_pyr_bf16_640)
    bf16_kernel = lambda: roi_crop_cuda(levels, boxes, valid, s, EXACT_EXTENT, "pyramid", True)  # noqa: E731
    ms, windows = median_ms(bf16_kernel, 100)
    result["pyramid_bf16"] = dict(
        err=err_bf16, ms=ms, windows=windows, host_ms=host_ms(bf16_kernel, 100),
        device_ms=device_ms(bf16_kernel, 100, "roi_crop_kernel"),
        plain_ms=cuda_ms(lambda: crop_and_resize_plain(levels, boxes, valid, s, round_bf16=True),
                         10, 1),
        bound=result["pyramid"]["bound"])
    print(f"roi pyramid bf16 rounding: max err {err_bf16}, kernel {ms:.4f} ms (windows "
          f"{windows}), device {result['pyramid_bf16']['device_ms']:.4f} ms, host issue "
          f"{result['pyramid_bf16']['host_ms']:.4f} ms, plain "
          f"{result['pyramid_bf16']['plain_ms']:.3f} ms")

    # an all-invalid batch: every slot zero, in both modes
    valid = torch.zeros_like(valid)
    for mode in ("dense", "pyramid"):
        for round_bf16 in (False, True):
            got = roi_error(frames, boxes, valid, s, mode, round_bf16)[1]
            if bool(got.any()):
                fail(f"ROI kernel ({mode}): an all-invalid batch gave non-zero crops")
    print("roi: an all-invalid batch gives zero crops in both modes, with and without bf16 "
          "rounding")
    return result


# --------------------------------------------------------------------- #
# stem kernel                                                           #
# --------------------------------------------------------------------- #

def bf16_ulp_error(got, want) -> float:
    """Largest |got - want| in units of the bf16 ulp at the larger
    magnitude, where that ulp is at least 1e-5 (below 2^-10 the float32
    sums' rounding noise, ~1e-6, exceeds an ulp, and 1e-5 is the unit)."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    ulp = torch.ldexp(torch.ones_like(g), e - 8).clamp(min=1e-5)
    return float(((g - w).abs() / ulp).max())


def stem_error(result: dict, got, want, what: str) -> None:
    """Hold one stem output to the plain version's; the worst error of each
    output type goes into ``result``."""
    if got.shape != want.shape or not got.permute(0, 3, 1, 2).is_contiguous():
        fail(f"stem kernel {what}: shape or layout differs")
    err = float((got.float() - want.float()).abs().max())
    if got.dtype == torch.float32:
        result["f32_err"] = max(result["f32_err"], err)
        if not err <= STEM_TOL:
            fail(f"stem kernel {what} f32: max abs error {err} > {STEM_TOL}")
    else:
        ulps = bf16_ulp_error(got, want)
        result["bf16_err"] = max(result["bf16_err"], err)
        result["bf16_ulps"] = max(result["bf16_ulps"], ulps)
        if not ulps <= 1.0:
            fail(f"stem kernel {what} bf16: {ulps} ulps from the plain version")


def stem_weights(gen, c: int, dev):
    kernel = torch.randn((3, 3, 3, c), generator=gen, device=dev) / (255 * 27 ** 0.5)
    bias = torch.randn(c, generator=gen, device=dev) * 0.1
    return kernel, bias, pack_stem_params(kernel.reshape(27, c), bias)


def check_stem_edges(dev, gen, result: dict) -> None:
    """The stem kernel at its tile and pair edges (``STEM_EDGE_*``), through
    ``stem_cuda`` (``fused_stem`` takes H % 80 == 0 only)."""
    n = 0
    for c in STEM_EDGE_C:
        kernel, bias, params = stem_weights(gen, c, dev)
        for h in STEM_EDGE_H:
            for w in STEM_EDGE_W:
                for fill in STEM_EDGE_FILLS:
                    if fill == "random":
                        frames = torch.randint(0, 256, (2, h, w, 3), generator=gen,
                                               device=dev, dtype=torch.uint8)
                    else:
                        frames = torch.full((2, h, w, 3), fill, device=dev, dtype=torch.uint8)
                    for dtype in (torch.float32, torch.bfloat16):
                        got = stem_cuda(frames, kernel.reshape(27, c), bias, dtype, params)
                        want = stem_plain(frames, kernel, bias, dtype)
                        torch.cuda.synchronize()
                        stem_error(result, got.permute(0, 2, 3, 1), want,
                                   f"2x{h}x{w} C={c} {fill} frames")
                        n += 1
    print(f"stem edges: {n} cases within tolerance")


def check_stem(dev):
    """The stem kernel vs ``stem_plain`` on every case and both output
    types; the serving case timed in bf16 beside the cuDNN stem."""
    torch.backends.cudnn.allow_tf32 = False  # the plain float32 conv is float32
    gen = torch.Generator(device=dev).manual_seed(3)
    result = dict(f32_err=0.0, bf16_err=0.0, bf16_ulps=0.0)
    for i, (b, h, w, c) in enumerate(STEM_CASES):
        frames = torch.randint(0, 256, (b, h, w, 3), generator=gen, device=dev,
                               dtype=torch.uint8)
        kernel, bias, params = stem_weights(gen, c, dev)
        for dtype in (torch.float32, torch.bfloat16):
            got = fused_stem(frames, kernel, bias, dtype, params)
            want = stem_plain(frames, kernel, bias, dtype)
            torch.cuda.synchronize()
            stem_error(result, got, want, f"{b}x{h}x{w} C={c}")
            del got, want
        if i:
            continue
        # the serving case, bf16 out, as the main path runs it
        kern = lambda: fused_stem(frames, kernel, bias, torch.bfloat16, params)  # noqa: E731
        ms, windows = median_ms(kern, 50)
        host = host_ms(kern, 50)
        dev_ms = device_ms(kern, 50, "stem_tiled_kernel")
        plain_ms = cuda_ms(lambda: stem_plain(frames, kernel, bias, torch.bfloat16), 5, 1)
        # what the port ran before at this size: the canvas cast, then cuDNN
        canvas = frames.permute(0, 3, 1, 2).to(torch.bfloat16)
        w_oihw = kernel.permute(3, 2, 0, 1).to(torch.bfloat16)
        b16 = bias.to(torch.bfloat16)
        lib = lambda: F.silu(F.conv2d(canvas, w_oihw, b16, stride=2, padding=1))  # noqa: E731
        library_ms = cuda_ms(lib, 20)
        cast_ms = cuda_ms(lambda: frames.permute(0, 3, 1, 2).to(torch.bfloat16), 20)
        n_out = b * c * (h // 2) * (w // 2)
        # frames read once, bf16 out written once; 27 multiply-adds (2 ops
        # each), the bias add and SiLU's add, divide and multiply per output
        n_bytes = frames.numel() + 2 * n_out + 4 * 28 * c
        result.update(ms=ms, windows=windows, host_ms=host, device_ms=dev_ms,
                      plain_ms=plain_ms, library_ms=library_ms, cast_ms=cast_ms,
                      bound=bound(n_bytes, n_out * (2 * 27 + 4)))
        print(f"stem B={b} {h}x{w} C={c} bf16: kernel {ms:.4f} ms (windows {windows}), "
              f"device {dev_ms:.4f} ms, host issue {host:.4f} ms, plain {plain_ms:.3f} ms, "
              f"cuDNN conv+bias+SiLU {library_ms:.4f} ms after a {cast_ms:.4f} ms canvas "
              f"cast, bound {result['bound'][0]:.4f} ms ({result['bound'][1]})")
        del canvas
    check_stem_edges(dev, gen, result)
    print(f"stem: max abs error f32 {result['f32_err']:.3g}, bf16 {result['bf16_err']:.3g} "
          f"({result['bf16_ulps']:.3g} ulp)")
    return result


# --------------------------------------------------------------------- #
# bf16 SiLU / sigmoid kernel                                            #
# --------------------------------------------------------------------- #

def check_act(dev) -> dict:
    """The bf16 SiLU / sigmoid kernel vs its plain version (five / four
    torch passes, each step rounded to bf16): on every element of
    ACT_CASES and of the timed shapes (ACT_SILU_SHAPE, ACT_SIGMOID_SHAPE);
    within one bf16 ulp (bit-equal expected: each step rounds as the plain
    version's), the share of elements that differ printed.  Timed beside
    the plain version and torch's one-pass op (``F.silu`` /
    ``torch.sigmoid``, which round once: not the same function, the
    yardstick of one elementwise pass)."""
    gen = torch.Generator(device=dev).manual_seed(6)
    out = {}
    for silu, shape in ((True, ACT_SILU_SHAPE), (False, ACT_SIGMOID_SHAPE)):
        name = "silu_bf16" if silu else "sigmoid_bf16"
        fn = act_ops.silu if silu else act_ops.sigmoid
        plain = act_ops.silu_bf16_plain if silu else act_ops.sigmoid_bf16_plain
        ulps, err, differ, n = 0.0, 0.0, 0, 0
        for case in (*ACT_CASES, shape):
            x = (torch.randn(case, generator=gen, device=dev) * 4).bfloat16()
            got, want = fn(x), plain(x)
            torch.cuda.synchronize()
            ulps = max(ulps, bf16_ulp_error(got, want))
            err = max(err, float((got.float() - want.float()).abs().max()))
            differ += int((got != want).sum())
            n += got.numel()
            if not ulps <= 1.0:
                fail(f"{name} kernel {case}: {ulps} bf16 ulps from the plain version")
        ms, windows = median_ms(lambda: fn(x), 50)
        once = F.silu if silu else torch.sigmoid
        r = dict(shape=list(shape), ms=ms, windows=windows, host_ms=host_ms(lambda: fn(x), 50),
                 device_ms=device_ms(lambda: fn(x), 50, "act_vec_kernel"),
                 plain_ms=cuda_ms(lambda: plain(x), 20), library_ms=cuda_ms(lambda: once(x), 50),
                 max_ulps=ulps, max_abs_err=err, mismatch_share=differ / n,
                 # each value read once and written once, 2 bytes each; the
                 # five (four) operations per value are noise beside that
                 bound=bound(4 * x.numel(), (5 if silu else 4) * x.numel()))
        print(f"{name} kernel {tuple(shape)}: {ms:.4f} ms (windows {windows}), device "
              f"{r['device_ms']:.4f} ms, host issue {r['host_ms']:.4f} ms; the plain version's "
              f"{5 if silu else 4} passes {r['plain_ms']:.4f} ms, torch's one-rounding op "
              f"{r['library_ms']:.4f} ms; bound {r['bound'][0]:.4f} ms ({r['bound'][1]}); "
              f"{differ} of {n} elements differ from the plain version ({ulps:.3g} ulp)")
        out[name] = r
    return out


# --------------------------------------------------------------------- #
# small pipeline: card vs CPU                                           #
# --------------------------------------------------------------------- #

def peaked_frames(seed=11, batch=2, h=200, w=300):
    rng = np.random.default_rng(seed)
    frames = (rng.uniform(0, 0.25, (batch, h, w, 3)) * 255).astype(np.uint8)
    for i in range(batch):
        for k in range(3):
            x, y = 40 + 80 * k, 50 + 40 * i
            frames[i, y : y + 40, x : x + 40] = 255
    return frames


def candidate_scores(pipe, frames) -> torch.Tensor:
    with torch.inference_mode():
        f = torch.as_tensor(frames).to(pipe.device)
        _, scores, _ = pipe._candidates(pipe._detect(pipe._stem(f)))
    return scores.cpu()


def small_pipeline(device):
    return TwoStagePipeline.initialize(SMALL, seed=3, device=device)


def check_small_pipeline(dev, seed: int, h: int, w: int, make=small_pipeline,
                         what: str = "small pipeline"):
    """A float32 pipeline built by ``make(device)`` (SMALL's by default) on
    the card vs on the CPU, frame by frame, on the h x w peaked scene drawn
    from ``seed``.

    Each frame gets a conf threshold in a gap of its candidate scores wider
    than 20x the card-vs-CPU score difference, so that both runs take the
    same discrete decisions; then valid, class ids and labels must agree
    exactly, boxes within 1e-2 px, scores 1e-5, probabilities 1e-4.  The
    stem kernel runs on canvas-sized frames of the default detector, and
    nowhere else.
    """
    gpu, cpu = make(dev), make("cpu")
    what = f"{what} {h}x{w}"
    frames = peaked_frames(seed, h=h, w=w)
    before = launch_counts()["stem"]
    n_valid = 0
    for i in range(frames.shape[0]):
        f = frames[i : i + 1]
        s_cpu, s_gpu = candidate_scores(cpu, f)[0], candidate_scores(gpu, f)[0]
        noise = float((s_cpu - s_gpu).abs().max())
        gaps = s_cpu[:-1] - s_cpu[1:]
        ok = [j for j in range(1, 9) if bool((gaps[:j] > 20 * noise + 1e-7).all())]
        if not ok:
            fail(f"{what} frame {i}: no well-separated conf threshold")
        j = ok[-1]
        conf = float((s_cpu[j - 1] + s_cpu[j]) / 2)
        got = {k: v.cpu() for k, v in gpu.run_fused(f, conf).items()}
        want = cpu.run_fused(f, conf)
        for k in ("valid", "det_class_ids"):
            if not torch.equal(got[k], want[k]):
                fail(f"{what} frame {i}: {k} differs card vs CPU")
        for k, tol in (("boxes", 1e-2), ("det_scores", 1e-5)):
            err = float((got[k] - want[k]).abs().max())
            if not err <= tol:
                fail(f"{what} frame {i}: {k} differs by {err} > {tol}")
        # crops compare where both truncated the box to the same pixels (a
        # coordinate within float noise of an integer may floor either way)
        same = (got["boxes"].floor() == want["boxes"].floor()).all(-1)
        for k in ("cls_probs", "cls_scores"):
            err = float((got[k] - want[k]).abs()[same].max())
            if not err <= 1e-4:
                fail(f"{what} frame {i}: {k} differs by {err} > 1e-4")
        p = want["cls_probs"].sort(-1, descending=True).values
        clear = same & ((p[..., 0] - p[..., 1]) > 1e-5)
        if not torch.equal(got["cls_labels"][clear], want["cls_labels"][clear]):
            fail(f"{what} frame {i}: cls_labels differ card vs CPU")
        n_valid += int(want["valid"].sum())
        print(f"{what} frame {i}: card == CPU (conf {conf:.8f}, "
              f"{j} candidates over it, score noise {noise:.3g})")
    if n_valid == 0:
        fail(f"{what}: no valid detection to compare")
    stem_expected = not gpu._injected and gpu._canvas_sized(torch.from_numpy(frames))
    if stem_expected != (launch_counts()["stem"] > before):
        fail(f"{what}: the stem kernel ran where it should not, or not where it should")


# --------------------------------------------------------------------- #
# the main path                                                         #
# --------------------------------------------------------------------- #

def check_outputs(out, b: int, d: int, h: int, w: int, n_cls: int, what: str) -> None:
    shapes = {"boxes": (b, d, 4), "det_scores": (b, d), "det_class_ids": (b, d),
              "valid": (b, d), "cls_probs": (b, d, n_cls), "cls_labels": (b, d),
              "cls_scores": (b, d)}
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape:
            fail(f"{what}: {k} has shape {tuple(out[k].shape)}, expected {shape}")
        if not bool(torch.isfinite(out[k].double()).all()):
            fail(f"{what}: {k} is not finite")
    bx = out["boxes"]
    if bool((bx < 0).any()) or bool((bx[..., [0, 2]] > w).any()) or bool((bx[..., [1, 3]] > h).any()):
        fail(f"{what}: boxes outside the frame")
    # every valid slot was classified (the budget clears the valid bit of
    # the slots it skips)
    sums = out["cls_probs"].sum(-1)[out["valid"]]
    if sums.numel() and float((sums - 1).abs().max()) > 1e-3:
        fail(f"{what}: classifier probabilities do not sum to 1")


def issue_sync_free(fn, what: str):
    """``fn()`` issued under ``set_sync_debug_mode("error")`` with the launch
    counts zeroed just before; returns (its result, the counts just after)."""
    reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    except RuntimeError as e:
        fail(f"{what} synchronised the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = launch_counts()
    torch.cuda.synchronize()
    return out, counts


def main_path(dev):
    """Full width, serving config, the MAIN_RUNS.  Each run is issued under
    ``set_sync_debug_mode("error")``: a host synchronisation raises.
    Returns launch counts, timings and the runs (pipeline, frames, ...)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    runs = []
    for b, h, w, roi_impl, dtype in MAIN_RUNS:
        cfg = dataclasses.replace(SERVING, cls_crop_budget=4 * b, roi_impl=roi_impl)
        t0 = time.perf_counter()
        pipe = TwoStagePipeline.initialize(cfg, seed=0, dtype=dtype, device=dev)
        frames = torch.randint(0, 256, (b, h, w, 3), generator=gen, device=dev, dtype=torch.uint8)
        area = torch.ones(b, device=dev)
        pipe.run_fused(frames, area_scale=area)  # warm-up (cuDNN algorithm selection)
        torch.cuda.synchronize()
        roi_impl = f"{roi_impl} {str(dtype).split('.')[-1]}"
        print(f"pipeline b={b} {h}x{w} {roi_impl}: init + first run "
              f"{time.perf_counter() - t0:.1f} s")
        runs.append((pipe, frames, area, b, h, w, roi_impl))

    # launch counts per run (zeroed just before, read just after) and
    # summed over the three
    outs, run_counts = [], []
    for pipe, frames, area, b, h, w, roi_impl in runs:
        out, run_count = issue_sync_free(lambda: pipe.run_fused(frames, area_scale=area),
                                         f"run_fused b={b} {h}x{w} {roi_impl}")
        outs.append(out)
        run_counts.append(run_count)
    counts = {name: sum(c[name] for c in run_counts) for name in run_counts[0]}
    print("main path: every run issued without a host synchronisation")
    for out, (pipe, _, _, b, h, w, roi_impl) in zip(outs, runs):
        check_outputs(out, b, pipe.cfg.crop_det_budget, h, w,
                      pipe.cfg.num_classifier_classes, f"run_fused b={b} {h}x{w} {roi_impl}")
    for name, n in counts.items():
        # the bf16 sigmoid kernel is the zoo's (EfficientNet-B0's gates)
        if n < 1 and name != "sigmoid_bf16":
            fail(f"kernel {name} was not launched on the main path")
    print(f"main path launch counts: {counts}, per run {run_counts}")

    timings = []
    for pipe, frames, _, b, h, w, roi_impl in runs:
        ms, windows = median_ms(lambda: pipe.run_fused(frames), 20, 2)
        timings.append(dict(batch=b, frame=f"{h}x{w}", roi_impl=roi_impl,
                            ms_per_batch=ms, fps=b / ms * 1e3, windows_ms=windows))
        print(f"run_fused b={b} {h}x{w} {roi_impl}: {ms:.3f} ms/batch, "
              f"{b / ms * 1e3:.1f} FPS (windows {windows})")
    return counts, run_counts, timings, runs


def check_detect(dev):
    """The staged ``detect`` at full width with the default NMSConfig (512
    candidates, 64 detections), the path that runs the NMS kernel at
    K=512: DETECT_BATCH [0, 1] canvases from a seed, issued under
    ``set_sync_debug_mode("error")`` with the launch counts zeroed just
    before and read just after; outputs finite, of their shapes, and equal
    to ``nms_sorted`` over the same candidates (``_detect_top``) with the
    plain keep mask ``suppress_sorted`` on the card.  The conf threshold
    sits at the 256th candidate score, so about half of each image's
    candidates are valid.  Timed end to end, and the NMS kernels' device
    time inside it."""
    b, s = DETECT_BATCH, SERVING.det_input_size
    cfg = dataclasses.replace(SERVING, nms=NMSConfig())
    k = cfg.nms.max_candidates
    pipe = TwoStagePipeline.initialize(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    canvas = torch.rand((b, s, s, 3), generator=gen, device=dev)
    boxes, scores, cls = pipe._detect_top(canvas, k)
    conf = float(scores[:, k // 2 - 1].min())
    pipe.detect(canvas, conf)  # warm-up
    torch.cuda.synchronize()
    out, counts = issue_sync_free(lambda: pipe.detect(canvas, conf), f"detect b={b}")
    if counts["nms_suppress"] != 1:
        fail(f"detect launched the NMS kernel {counts['nms_suppress']} times, not once")
    d = cfg.nms.max_detections
    for key, shape in (("boxes", (b, d, 4)), ("scores", (b, d)), ("class_ids", (b, d)),
                       ("valid", (b, d))):
        if tuple(out[key].shape) != shape or not bool(torch.isfinite(out[key].double()).all()):
            fail(f"detect: {key} is not finite of shape {shape}")
    if not bool(out["valid"].any()):
        fail("detect: no valid detection to compare")
    kernel_path = nms_ops.suppress
    nms_ops.suppress = lambda bx, v, c, t: suppress_sorted(bx, v, c, t)
    try:
        want = nms_ops.nms_sorted(boxes, scores, cls, conf, cfg.nms.iou_threshold, d)
    finally:
        nms_ops.suppress = kernel_path
    for key, w in zip(("boxes", "scores", "class_ids", "valid"), want):
        if not torch.equal(out[key], w):
            fail(f"detect: {key} differs from nms_sorted with the plain keep mask")
    ms, windows = median_ms(lambda: pipe.detect(canvas, conf), 10, 2)
    nms_ms = device_ms(lambda: pipe.detect(canvas, conf), 10, "nms_")
    n_valid = int((scores > conf).sum())
    result = dict(batch=b, launches=counts, ms_per_batch=ms, windows_ms=windows,
                  nms_device_ms=nms_ms, conf=conf, valid_candidates=n_valid,
                  detections=int(out["valid"].sum()))
    print(f"detect b={b} {s}x{s}, K={k}: issued without a host synchronisation, equal to "
          f"nms_sorted with suppress_sorted; {n_valid} of {b * k} candidates valid, "
          f"{result['detections']} detections; {ms:.3f} ms/batch (windows {windows}), "
          f"NMS kernels {nms_ms:.4f} ms device; launch counts {counts}")
    return result


# --------------------------------------------------------------------- #
# streaming                                                             #
# --------------------------------------------------------------------- #

class RamStreamingRunner(StreamingRunner):
    """A StreamingRunner whose decode hands out letterboxed canvases held
    in RAM: batch j of a run is canvases[j % len(canvases)]."""

    def __init__(self, pipe, canvases, geoms, **kw):
        super().__init__(pipe, use_native_loader=False, **kw)
        self.canvases, self.geoms = canvases, geoms

    def _decode_batch(self, paths, out=None):
        j = int(paths[0].rsplit("/", 1)[1]) // self.batch_size
        return self.canvases[j % len(self.canvases)], self.geoms


def check_streaming(dev, pipe, device_fps: float):
    """``StreamingRunner.run`` over STREAM_BATCHES batches of canvases vs a
    direct ``run_fused`` + host unmap of the same canvases."""
    b, s = STREAM_BATCH, pipe.cfg.det_input_size
    src_h, src_w = STREAM_SOURCE
    ratio, dw, dh, (new_w, new_h), (top, _, left, _) = letterbox_params(src_h, src_w, s)
    geoms = np.tile(np.array([ratio, dw, dh, src_w, src_h], np.float32), (b, 1))
    rng = np.random.default_rng(5)
    canvases = []
    for _ in range(STREAM_DISTINCT):
        c = np.full((b, s, s, 3), 114, np.uint8)
        c[:, top : top + new_h, left : left + new_w] = rng.integers(
            0, 256, (b, new_h, new_w, 3), dtype=np.uint8)
        canvases.append(c)
    refs = []
    area = torch.from_numpy(area_scale_of(geoms)).to(dev)
    for c in canvases:
        out = {k: v.cpu().numpy() for k, v in
               pipe.run_fused(torch.from_numpy(c).to(dev), area_scale=area).items()}
        out["boxes"] = unmap_boxes(out["boxes"], geoms)
        refs.append(out)

    runner = RamStreamingRunner(pipe, canvases, geoms, batch_size=b, inflight=2)
    paths = [f"ram://{i}" for i in range(STREAM_BATCHES * b)]
    # warm-up: one batch per staging slot, so every pinned buffer exists
    # before the timed run (allocating pinned memory is slow)
    for _ in runner.run(paths[: len(runner._slots) * b]):
        pass
    reset_launch_counts()
    t0 = time.perf_counter()
    results = list(runner.run(paths))
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    if len(results) != STREAM_BATCHES or counts["stem"] < STREAM_BATCHES:
        fail(f"streaming: {len(results)} batches, stem launched {counts['stem']} times")
    for i, (batch_paths, out) in enumerate(results):
        if batch_paths != paths[i * b : (i + 1) * b]:
            fail(f"streaming batch {i}: paths out of order")
        ref = refs[i % STREAM_DISTINCT]
        for k, v in ref.items():
            if k in ("valid", "det_class_ids", "cls_labels"):
                if not np.array_equal(out[k], v):
                    fail(f"streaming batch {i}: {k} differs from run_fused")
            elif not float(np.abs(out[k].astype(np.float64) - v).max()) <= 1e-5:
                fail(f"streaming batch {i}: {k} differs from run_fused by more than 1e-5")
    ram = runner.benchmark_ram(canvases[0], n_batches=STREAM_BATCHES)
    runner.close()
    result = dict(batches=STREAM_BATCHES, batch=b, inflight=2, seconds=seconds,
                  fps=STREAM_BATCHES * b / seconds, device_only_fps=device_fps,
                  benchmark_ram_fps=ram["fps"], launches=counts,
                  native_loader_built=native_loader.available(),
                  native_loader_error=(native_loader.build_error() or "")[:200] or None)
    print(f"streaming: {STREAM_BATCHES} batches of {b} equal to run_fused; "
          f"{result['fps']:.1f} frames/s streamed, {device_fps:.1f} device-only run_fused, "
          f"{ram['fps']:.1f} benchmark_ram; native loader built: "
          f"{result['native_loader_built']}")
    return result


# --------------------------------------------------------------------- #
# the zoo: injected detectors and the other classifiers                 #
# --------------------------------------------------------------------- #

def zoo_pipeline(cfg, variant: str, arch: str, device, dtype=torch.float32, seed: int = 7):
    """A pipeline on ``cfg`` with the ``variant`` detector injected
    (``detector_kwargs``) and the ``arch`` classifier, weights from
    ``weights/seeded.py::seeded_state`` at ZOO_GAIN."""
    cfg = dataclasses.replace(cfg, classifier_arch=arch)
    kw = detector_kwargs(variant, cfg, device)
    clf = build_classifier(arch, cfg.num_classifier_classes)
    return TwoStagePipeline(cfg, seeded_state(kw["det_model"], seed, ZOO_GAIN),
                            seeded_state(clf, seed + 1, ZOO_GAIN), dtype, device, **kw)


def check_path_kernels(pipe, frames, area, what: str) -> dict:
    """K1 and K2 on one run's own inputs, the candidates and boxes its
    ``run_fused`` hands them (through the pipeline's stage methods), against
    their plain versions: the NMS keep mask bit-equal to
    ``suppress_sorted``, the crop within ROI_TOL of ``crop_and_resize_plain``
    in the mode and rounding the pipeline runs (dense, or the pyramid for
    ``roi_impl="pallas"``; bf16 rounding in a bf16 pipeline).  The zoo runs
    reach shapes the kernel checks do not (at B=32, D=8 the crop kernel
    cuts each box into row bands sized from B*D), and so do the eval and
    e2e CLI runs (K1 at K=512 on B=8, K2 on 2048x2048 frames, the pyramid
    over 4 levels at D=64)."""
    cfg = pipe.cfg
    conf, thr = cfg.benchmark_conf, cfg.nms.iou_threshold
    with torch.inference_mode():
        boxes, scores, cls = pipe._candidates(pipe._detect(pipe._stem(frames)))
        valid = scores > conf
        keep = nms_suppress_cuda(boxes, cls.to(torch.int32), valid, thr)
        want = suppress_sorted(boxes, valid, cls, thr)
        torch.cuda.synchronize()
        mismatches = int((keep != want).sum())
        if mismatches:
            fail(f"{what}: {mismatches} NMS keep bits differ from suppress_sorted on the "
                 "run's candidates")
        bx, _, _, v = pipe._suppress(boxes, scores, cls, conf)
        orig, v = pipe._unmap(bx, v, int(frames.shape[1]), int(frames.shape[2]), area)
        if not bool(v.any()):
            fail(f"{what}: no box to crop")
        mode = "pyramid" if cfg.roi_impl == "pallas" else "dense"
        bf16 = pipe.dtype == torch.bfloat16
        roi_err = roi_error(frames, orig, v, cfg.cls_input_size, mode, bf16)[0]
    roi_mode = mode + (", bf16 rounding" if bf16 else "")
    result = dict(nms_valid=int(valid.sum()), nms_kept=int(keep.sum()), nms_mismatches=0,
                  roi_boxes=int(v.sum()), roi_shape=list(orig.shape[:2]), roi_mode=roi_mode,
                  roi_max_abs_err=roi_err)
    print(f"{what}: on the run's inputs the NMS kernel equals suppress_sorted "
          f"({result['nms_kept']} of {result['nms_valid']} valid candidates kept) and the "
          f"crop ({roi_mode}, B, D = {result['roi_shape']}) is within "
          f"{roi_err} of the plain crop ({result['roi_boxes']} boxes)")
    return result


def zoo_path(dev):
    """ZOO_RUNS at the serving configuration in bf16 on device frames: each
    ``run_fused`` sync-free, with the NMS and dense ROI kernels launched
    once each and the stem kernel and pyramid crop never; both kernels held
    against their plain versions on the run's own inputs; timed in WINDOWS
    windows; the kernels' device time inside the first run; and
    the anchor-based detector's ``detect_candidates`` over every
    prediction."""
    gen = torch.Generator(device=dev).manual_seed(8)
    s = ZOO_SERVING.det_input_size
    want_counts = {"nms_suppress": 1, "roi_crop_dense": 1, "roi_crop_pyramid": 0,
                   "roi_crop_pyramid_bf16": 0, "stem": 0}
    # the bf16 activation kernel: SiLU in every detector but the anchor-free
    # YOLOv5n (torch's F.silu, models/yolov5.py) and in EfficientNet-B0,
    # sigmoid in EfficientNet-B0's gates only
    act_runs = {"yolov11n": ("silu_bf16",), "yolov5n": (),
                "yolov5n_legacy": ("silu_bf16", "sigmoid_bf16")}
    runs = []
    for i, (variant, arch, b) in enumerate(ZOO_RUNS):
        cfg = dataclasses.replace(ZOO_SERVING, cls_crop_budget=4 * b)
        what = f"zoo {variant} + {arch} b={b}"
        pipe = zoo_pipeline(cfg, variant, arch, dev, torch.bfloat16, seed=10 * i)
        frames = torch.randint(0, 256, (b, s, s, 3), generator=gen, device=dev, dtype=torch.uint8)
        area = torch.ones(b, device=dev)
        pipe.run_fused(frames, area_scale=area)  # warm-up (cuDNN algorithm selection)
        out, counts = issue_sync_free(lambda: pipe.run_fused(frames, area_scale=area), what)
        if {k: counts[k] for k in want_counts} != want_counts:
            fail(f"{what}: launch counts {counts}, expected {want_counts}")
        for k in ("silu_bf16", "sigmoid_bf16"):
            if (counts[k] > 0) != (k in act_runs[variant]):
                fail(f"{what}: {k} launched {counts[k]} times")
        check_outputs(out, b, cfg.crop_det_budget, s, s, cfg.num_classifier_classes, what)
        if not bool(out["valid"].any()):
            fail(f"{what}: no valid detection")
        kernel_checks = check_path_kernels(pipe, frames, area, what)
        ms, windows = median_ms(lambda: pipe.run_fused(frames), 20, 2)
        host = host_ms(lambda: pipe.run_fused(frames), 10)
        run = dict(detector=variant, classifier=arch, batch=b, frame=f"{s}x{s}", launches=counts,
                   valid=int(out["valid"].sum()), ms_per_batch=ms, fps=b / ms * 1e3,
                   windows_ms=windows, host_ms=host, kernel_checks=kernel_checks)
        if i == 0:
            fused = lambda: pipe.run_fused(frames)  # noqa: E731
            run["nms_device_ms"] = device_ms(fused, 10, "nms_")
            run["roi_device_ms"] = device_ms(fused, 10, "roi_crop_kernel")
        print(f"{what} {s}x{s}: sync-free, launches {counts}, {run['valid']} valid; "
              f"{ms:.3f} ms/batch, {run['fps']:.1f} FPS (windows {windows}), host issue "
              f"{host:.3f} ms"
              + (f"; NMS {run['nms_device_ms']:.4f} ms, ROI {run['roi_device_ms']:.4f} ms "
                 "device" if i == 0 else ""))
        runs.append(run)
        if variant == "yolov5n_legacy":
            runs[-1]["detect_candidates"] = check_zoo_candidates(pipe, gen, b, s)
        del pipe, frames, out
    return runs


def check_zoo_candidates(pipe, gen, b: int, s: int) -> dict:
    """``detect_candidates`` of the anchor-based detector at
    ``eval_max_candidates=0``: every one of its 3 x 8,400 predictions per
    image, score-descending and finite, issued without a host
    synchronisation; NMS and crop kernels not launched."""
    canvas = torch.rand((b, s, s, 3), generator=gen, device=pipe.device)
    (boxes, scores, cls), counts = issue_sync_free(
        lambda: pipe.detect_candidates(canvas), "zoo detect_candidates")
    k, n = pipe.cfg.nms.eval_max_candidates, 3 * sum((s // st) ** 2 for st in (8, 16, 32))
    if k != 0 or tuple(scores.shape) != (b, n) or tuple(boxes.shape) != (b, n, 4):
        fail(f"zoo detect_candidates at eval_max_candidates={k}: scores {tuple(scores.shape)}")
    if not (bool(torch.isfinite(boxes).all()) and bool((scores[:, :-1] >= scores[:, 1:]).all())):
        fail("zoo detect_candidates: boxes not finite or scores not descending")
    # the detector's own bf16 SiLUs run the activation kernel; nothing else
    if any(c for key, c in counts.items() if key not in ("silu_bf16", "sigmoid_bf16")):
        fail(f"zoo detect_candidates launched kernels: {counts}")
    print(f"zoo detect_candidates b={b}: {scores.shape[1]} candidates per image, sync-free")
    return dict(batch=b, candidates_per_image=int(scores.shape[1]), launches=counts,
                class_ids=sorted(int(c) for c in cls.unique()))


# --------------------------------------------------------------------- #
# the evaluation core                                                   #
# --------------------------------------------------------------------- #

class RamEvaluator(PipelineEvaluator):
    """A PipelineEvaluator whose frames come from memory (path -> frame)
    and which records the wall time of its timed fused pass and of its
    staged mAP pass."""

    def __init__(self, pipe, frames: dict):
        super().__init__(pipe)
        self.frames = frames
        self.seconds = {"fused_pass": 0.0, "map_pass": 0.0}

    def _read_image(self, path):
        return self.frames.get(path)

    def _timed_fused_pass(self, *args):
        t0 = time.perf_counter()
        fps = super()._timed_fused_pass(*args)
        self.seconds["fused_pass"] += time.perf_counter() - t0
        return fps

    def run_images(self, images, conf, timings=None, eval_budget=False):
        t0 = time.perf_counter()
        out = super().run_images(images, conf, timings, eval_budget)
        if eval_budget:
            self.seconds["map_pass"] += time.perf_counter() - t0
        return out


def eval_states(seed: int):
    """SMALL's detector and classifier states, N(0, 1/fan_in) from a seed,
    with the detector's class outputs x3000 and the classifier's Dense x300
    (candidate scores and class probabilities spread over (0, 1), far apart
    next to the card-vs-CPU noise) and the DFL bins given a falling bias
    (small, varied boxes, about ten per frame after NMS)."""
    det = seeded_state(YoloLitePi(SMALL.detector), seed, gain=1.0)
    clf = seeded_state(build_classifier(SMALL.classifier_arch, SMALL.num_classifier_classes),
                       seed + 1, gain=1.0)
    for i in range(3):
        det[f"head.cls{i}_out.weight"] *= 3000.0
        det[f"head.reg{i}_out.weight"] *= 30.0
        det[f"head.reg{i}_out.bias"] = (-0.7 * torch.arange(16.0)).repeat(4)
    clf["fc.weight"] *= 300.0
    return det, clf


def separated_conf(scores: np.ndarray, lo: int, hi: int, sep: float) -> float:
    """A threshold in a gap of ``scores`` (images x candidates) with
    ``lo``..``hi`` scores over it in every image, each of them further than
    ``sep`` from it and from the others of its image."""
    flat = np.unique(scores.ravel())[::-1]
    for a, b in zip(flat[:-1], flat[1:]):
        conf = (float(a) + float(b)) / 2
        above = [np.sort(x[x > conf]) for x in scores]
        if (all(lo <= len(x) <= hi for x in above) and a - b > 2 * sep
                and all((np.diff(x) > sep).all() for x in above)):
            return conf
    fail(f"eval: no conf threshold with {lo}..{hi} candidates separated by {sep}")


def write_labels(labels_dir: str, paths, frames: dict, results, rng, num_classes: int) -> None:
    """YOLO labels from ``results`` (one per path; jittered, some dropped,
    some of another class); the last path gets no label file."""
    for p, res in zip(paths[:-1], results):
        h, w = frames[p].shape[:2]
        rows = []
        for b, c in zip(res["boxes"], res["labels"]):
            if rng.uniform() < 0.2:
                continue
            b = b + rng.normal(0, 3.0, 4)
            c = int(c) if rng.uniform() < 0.8 else (int(c) + 1) % num_classes
            rows.append(f"{c} {(b[0] + b[2]) / 2 / w:.6f} {(b[1] + b[3]) / 2 / h:.6f} "
                        f"{(b[2] - b[0]) / w:.6f} {(b[3] - b[1]) / h:.6f}\n")
        stem = os.path.splitext(os.path.basename(p))[0]
        with open(os.path.join(labels_dir, stem + ".txt"), "w") as f:
            f.writelines(rows)


def compare_eval_results(got, want, what: str) -> int:
    """Card results vs CPU results, image by image: counts equal, boxes
    within 1e-3 px (and no coordinate within 1e-3 of an integer unless both
    hold the same value, so truncation cannot differ), det scores 1e-6,
    labels exact, cls scores 1e-5.  Returns the detection count."""
    n = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if len(g["boxes"]) != len(w["boxes"]):
            fail(f"{what} image {i}: {len(g['boxes'])} detections on the card, "
                 f"{len(w['boxes'])} on the CPU")
        n += len(w["boxes"])
        far = np.abs(w["boxes"] - np.round(w["boxes"])) > 1e-3
        if not (far | (g["boxes"] == w["boxes"])).all():
            fail(f"{what} image {i}: a box edge within 1e-3 of an integer")
        if not np.array_equal(g["labels"], w["labels"]):
            fail(f"{what} image {i}: labels differ card vs CPU")
        for k, tol in (("boxes", 1e-3), ("det_scores", 1e-6), ("cls_scores", 1e-5)):
            err = float(np.abs(g[k] - w[k]).max()) if len(w[k]) else 0.0
            if not err <= tol:
                fail(f"{what} image {i}: {k} differs by {err} > {tol}")
    if n == 0:
        fail(f"{what}: no detection to compare")
    return n


def metric_row(m: dict) -> dict:
    return {k: (float(m[k]) if k not in ("tp", "fp", "fn") else int(m[k]))
            for k in ("precision", "recall", "f1", "mAP50", "mAP50_95", "tp", "fp", "fn")}


def check_eval_small(dev, tmp: str) -> dict:
    """The evaluator on the card vs on the CPU: SMALL's float32 pipeline
    (TF32 off) with :func:`eval_states` weights, EVAL_SMALL_SIZES frames
    from memory (landscape and portrait, a trailing partial batch), labels
    from the CPU run's detections.  The thresholds sit in gaps of the
    candidate scores more than 20x the card-vs-CPU noise wide; ``run_images``
    at both ``eval_budget`` settings per image as in
    :func:`compare_eval_results`; the reference metric row within 1e-6."""
    cfg = dataclasses.replace(SMALL, batch_size=2, input_color="bgr")
    frames = {f"ram://small/{i}": peaked_frames(seed=60 + i, batch=1, h=h, w=w)[0]
              for i, (h, w) in enumerate(EVAL_SMALL_SIZES)}
    paths = list(frames)
    det, clf = eval_states(11)
    card = RamEvaluator(TwoStagePipeline(cfg, det, clf, device=dev), frames)
    cpu = RamEvaluator(TwoStagePipeline(cfg, det, clf, device="cpu"), frames)
    images = [frames[p] for p in paths]
    canvases, _ = cpu._letterbox_batch(images)
    up = card._to_unit(canvases).cpu().numpy()
    if not np.array_equal(up, canvases.astype(np.float32) / 255.0):
        fail("eval: canvases divided by 255 on the card differ from the host's")
    s_cpu = cpu.pipe.detect_candidates(cpu._to_unit(canvases))[1].numpy()
    s_card = card.pipe.detect_candidates(card._to_unit(canvases))[1].cpu().numpy()
    noise = float(np.abs(s_cpu - s_card).max())
    sep = max(20 * noise, 1e-6)
    yolo_conf = separated_conf(s_cpu, 10, 22, sep)
    bench_conf = separated_conf(s_cpu[:, : cfg.nms.max_candidates], 3, 8, sep)
    n = {}
    for budget, conf in ((False, bench_conf), (True, yolo_conf)):
        want = cpu.run_images(images, conf, eval_budget=budget)
        n[budget] = compare_eval_results(card.run_images(images, conf, eval_budget=budget), want,
                                         f"eval run_images eval_budget={budget}")
        if budget:
            write_labels(tmp, paths, frames, want, np.random.default_rng(9),
                         cfg.num_classifier_classes)
    kw = dict(yolo_conf=yolo_conf, benchmark_conf=bench_conf, warmup=1)
    n_cls = cfg.num_classifier_classes
    want = metric_row(cpu.evaluate_dataset(paths, tmp, n_cls, **kw))
    got = metric_row(card.evaluate_dataset(paths, tmp, n_cls, **kw))
    for k, v in want.items():
        if not abs(got[k] - v) <= 1e-6:
            fail(f"eval reference row: {k} {got[k]} on the card, {v} on the CPU")
    if not 0 < want["mAP50"] < 1:
        fail(f"eval: a degenerate metric row {want}")
    print(f"eval small: card == CPU (score noise {noise:.3g}, yolo_conf {yolo_conf:.6f}, "
          f"benchmark_conf {bench_conf:.6f}; {n[False]} and {n[True]} detections), "
          f"reference row {got}")
    return dict(score_noise=noise, yolo_conf=yolo_conf, benchmark_conf=bench_conf,
                detections={"staged": n[False], "eval_budget": n[True]}, row=got)


def check_eval_full(dev, tmp: str) -> dict:
    """``evaluate_dataset(metrics_mode="reference")`` at the e2e app's
    defaults (yolo_plus_v2 + ShuffleNetV2-91, 640, B=8, float32, dense, 512
    candidates, 8,400 per image in the mAP pass, yolo_conf 0.001,
    benchmark_conf 0.25) over EVAL_FULL_FRAMES random 2048x2048 BGR frames
    from memory with random labels; launch counts zeroed just before and
    read just after: K1 at least once, K2 dense at least 4 times, K3 and
    the pyramid crop never.  Then K1 and K2 on the first batch's own
    inputs against their plain versions (:func:`check_path_kernels`)."""
    pipe = TwoStagePipeline.initialize(EVAL_FULL, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    n, s = EVAL_FULL_FRAMES, EVAL_FULL_SIZE
    on_card = torch.randint(0, 256, (n, s, s, 3), generator=gen, device=dev, dtype=torch.uint8)
    pixels = on_card.cpu().numpy()
    frames = {f"ram://full/{i:03d}": pixels[i] for i in range(n)}
    rng = np.random.default_rng(13)
    for p in frames:
        xy = rng.uniform(0.05, 0.8, (4, 2))
        wh = rng.uniform(0.01, 0.15, (4, 2))
        with open(os.path.join(tmp, os.path.basename(p) + ".txt"), "w") as f:
            f.writelines(f"{rng.integers(0, EVAL_FULL.num_classifier_classes)} {x + w / 2:.6f} {y + h / 2:.6f} {w:.6f} {h:.6f}\n"
                         for (x, y), (w, h) in zip(xy, wh))
    ev = RamEvaluator(pipe, frames)
    reset_launch_counts()
    t0 = time.perf_counter()
    m = ev.evaluate_dataset(list(frames), tmp, EVAL_FULL.num_classifier_classes,
                            yolo_conf=EVAL_FULL.yolo_conf,
                            benchmark_conf=EVAL_FULL.benchmark_conf, metrics_mode="reference")
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    if (counts["nms_suppress"] < 1 or counts["roi_crop_dense"] < 4 or counts["stem"]
            or counts["roi_crop_pyramid"] or counts["roi_crop_pyramid_bf16"]):
        fail(f"eval full width: launch counts {counts}")
    kernel_checks = check_path_kernels(pipe, on_card[: EVAL_FULL.batch_size], None,
                                       "eval full width")
    del on_card
    row = metric_row(m)
    if not all(0 <= row[k] <= 1 for k in ("precision", "recall", "f1", "mAP50", "mAP50_95")):
        fail(f"eval full width: metric row out of range {row}")
    if not (m["num_images"] == n and m["fps"] > 0):
        fail(f"eval full width: {m['num_images']} images, fps {m['fps']}")
    result = dict(frames=n, frame=f"{s}x{s}", batch=EVAL_FULL.batch_size, fps=m["fps"],
                  stage_ms_per_batch=m["stage_ms_per_batch"], seconds=seconds,
                  fused_pass_s=ev.seconds["fused_pass"], map_pass_s=ev.seconds["map_pass"],
                  staged_s=seconds - ev.seconds["fused_pass"] - ev.seconds["map_pass"],
                  row=row, launches=counts, kernel_checks=kernel_checks)
    print(f"eval full width: {json.dumps(result)}")
    return result


def eval_phase(dev) -> dict:
    """The evaluation core: small card vs CPU, then the e2e app's defaults
    at full width."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as small, tempfile.TemporaryDirectory() as full:
        result = dict(small=check_eval_small(dev, small), full=check_eval_full(dev, full))
    result["seconds"] = time.perf_counter() - t0
    print(f"eval phase (small check and full-width run): {result['seconds']:.1f} s")
    return result


# --------------------------------------------------------------------- #
# the e2e CLI on deployed artifacts                                     #
# --------------------------------------------------------------------- #

def write_artifacts(dev, root: str) -> dict:
    """The deployed artifact forms, written on the card with torch only:
    an Ultralytics training container (``best.pt``) of the YOLOv8 mirror at
    yolo_plus_v2's widths (conv weights N(0, ZOO_GAIN^2 / fan_in) with
    random BatchNorm statistics; the class outputs x200 with a bias of -25,
    so that, as a trained detector's, a few percent of the anchors score
    over the mAP pass's 0.001 and a few over 0.25; the DFL bins given a
    falling bias, so that boxes vary)
    and a torchvision ShuffleNetV2-91 ``.pth``.  The container loads back
    through the port's stub unpickler, each value the source's fp16
    rounding; the imported detector's head outputs (float32, TF32 off) are
    held against the mirror's own forward on the same fp16-rounded weights
    within ARTIFACT_TOL of the outputs' largest magnitude."""
    refs = load_test_module("torch_refs")
    c = YOLO_PLUS_V2
    torch.manual_seed(30)
    tm = load_test_module("torch_yolo_ref").YoloV8T(
        c.channels, c.depths, nc=1, reg_max=c.reg_max, neck_shortcut=c.neck_shortcut,
        neck_down=c.neck_down_channels)
    seeded_state(tm, 31, ZOO_GAIN)
    refs.randomize_bn_stats(tm, seed=32)
    with torch.no_grad():
        for i in range(3):
            tm.model[22].cv3[i][2].weight *= 200.0
            tm.model[22].cv3[i][2].bias.fill_(-25.0)
            tm.model[22].cv2[i][2].weight *= 30.0
            tm.model[22].cv2[i][2].bias.copy_((-0.7 * torch.arange(16.0)).repeat(4))
    tm = tm.eval().to(dev)
    clf = refs.ShuffleNetV2T(EVAL_FULL.num_classifier_classes)
    refs.randomize_bn_stats(clf, seed=33)
    art = {"pt": os.path.join(root, "best.pt"), "pth": os.path.join(root, "shufflenetv2.pth")}
    load_test_module("torch_artifacts").save_ultralytics_container(tm, art["pt"])
    torch.save(clf.to(dev).state_dict(), art["pth"])

    sd = load_torch_state_dict(art["pt"])
    want = {k: v.half().float().cpu().numpy() for k, v in tm.state_dict().items()}
    if set(sd) != set(want) or not all(np.array_equal(sd[k], want[k]) for k in want):
        fail("e2e artifacts: the container does not load back as the source's fp16 weights")
    art["det_vars"] = convert_detector_state_dict(defuse_state_dict(sd), c.depths)
    art["cls_vars"] = convert_classifier_state_dict("shufflenetv2",
                                                    load_torch_state_dict(art["pth"]))
    pipe = TwoStagePipeline.from_jax_vars(EVAL_FULL, art["det_vars"], art["cls_vars"], device=dev)
    ref = copy.deepcopy(tm).half().float().eval()
    x = torch.rand((2, 3, c.input_size, c.input_size),
                   generator=torch.Generator(device=dev).manual_seed(34), device=dev)
    with torch.inference_mode():
        reg, cls = ref(x)
        out = pipe.det_model(x)
    err = {k: float((out[k] - r).abs().max() / r.abs().max()) for k, r in
           (("reg", reg), ("cls", cls))}
    if not max(err.values()) <= ARTIFACT_TOL:
        fail(f"e2e artifacts: imported detector vs its source, relative error {err} > "
             f"{ARTIFACT_TOL}")
    art["detector_rel_err"] = err
    print(f"e2e artifacts: best.pt (stub unpickler, torch {torch.__version__}) and "
          f"shufflenetv2.pth load; imported detector vs the mirror's forward: relative error "
          f"{err} (tolerance {ARTIFACT_TOL})")
    del tm, ref, pipe
    return art


def write_jpegs(img_dir: str, sizes, gen) -> list:
    """Frames of the given (h, w) as JPEG files: smooth random content
    (a random 1/8-size image upsampled), with bright blocks on small ones."""
    import cv2

    os.makedirs(img_dir, exist_ok=True)
    paths = []
    for i, (h, w) in enumerate(sizes):
        small = torch.randint(0, 120, (h // 8, w // 8, 3), generator=gen, dtype=torch.uint8)
        img = cv2.resize(small.numpy(), (w, h), interpolation=cv2.INTER_LINEAR)
        if max(h, w) <= 640:
            for k in range(2):
                x0, y0 = 30 + 90 * k + 20 * i, 40 + 30 * k
                img[y0 : y0 + 40, x0 : x0 + 40] = 255
        paths.append(os.path.join(img_dir, f"img{i:03d}.jpg"))
        cv2.imwrite(paths[-1], img)
    return paths


def cli_outputs(out: str, combo: str, n_images: int, what: str) -> dict:
    """The CLI's files under ``out``: the summary row and the per-class
    results rows; fails when one is missing."""
    import csv

    files = [os.path.join(out, "comparison_summary.csv"),
             os.path.join(out, combo, f"{combo}_results.csv"),
             os.path.join(out, combo, f"{combo}_test_files.txt")]
    missing = [f for f in files if not os.path.isfile(f)]
    if missing:
        fail(f"{what}: the CLI wrote no {missing}")
    with open(files[0]) as f:
        summary = list(csv.DictReader(f))
    with open(files[1]) as f:
        per_class = list(csv.DictReader(f))
    with open(files[2]) as f:
        listed = f.read().split()
    if (len(summary) != 1 or int(summary[0]["num_test_images"]) != n_images
            or len(listed) != n_images):
        fail(f"{what}: summary {summary}, {len(listed)} files listed, expected {n_images}")
    return dict(summary=summary[0], per_class=per_class)


def check_cli_small(dev, art: dict, root: str) -> dict:
    """``apps/e2e.py::main`` with ``--device cuda`` and with ``--device cpu``
    at ``--det_input_size 160 --num_samples 2`` from the two artifacts, on
    JPEG frames and labels made from the CPU pipeline's own detections; both
    thresholds in gaps of the candidate scores more than 20x the card-vs-CPU
    noise wide (as :func:`check_eval_small`).  rc 0 both times; the summary
    row's metrics and the per-class rows within 1e-6, counts equal."""
    img_dir, lbl_dir = os.path.join(root, "images"), os.path.join(root, "labels")
    write_jpegs(img_dir, E2E_CLI_SMALL_FRAMES, torch.Generator().manual_seed(35))
    os.makedirs(lbl_dir)
    paths = sample_images(img_dir, 2, 42)  # the frames the CLI samples
    cfg = dataclasses.replace(EVAL_FULL, det_input_size=160,
                              detector=dataclasses.replace(YOLO_PLUS_V2, input_size=160))
    evs = {d: PipelineEvaluator(TwoStagePipeline.from_jax_vars(
        cfg, art["det_vars"], art["cls_vars"], device=d)) for d in (dev, "cpu")}
    import cv2

    images = [cv2.imread(p) for p in paths]
    canvases = evs["cpu"]._letterbox_batch(images)[0]
    s_cpu, s_card = (evs[d].pipe.detect_candidates(evs[d]._to_unit(canvases))[1].cpu().numpy()
                     for d in ("cpu", dev))
    noise = float(np.abs(s_cpu - s_card).max())
    sep = max(20 * noise, 1e-6)
    yolo_conf = separated_conf(s_cpu, 3, 40, sep)
    bench_conf = separated_conf(s_cpu[:, : cfg.nms.max_candidates], 1, 8, sep)
    results = evs["cpu"].run_images(images, yolo_conf, eval_budget=True)
    # write_labels leaves its last path without a label file: a path past
    # the two, so both sampled frames get labels
    write_labels(lbl_dir, paths + ["unlabelled"], dict(zip(paths, images)), results,
                 np.random.default_rng(36), cfg.num_classifier_classes)
    del evs
    argv = ["--input", img_dir, "--labels", lbl_dir, "--detector", art["pt"], "--classifier",
            art["pth"], "--det_input_size", "160", "--num_samples", "2", "--yolo_conf",
            repr(yolo_conf), "--benchmark_conf", repr(bench_conf), "--warmup", "1"]
    combo = "yolo_plus_v2+shufflenetv2"
    out = {}
    for d in ("cuda", "cpu"):
        rc = e2e_cli.main(argv + ["--device", d, "--output", os.path.join(root, d)])
        if rc != 0:
            fail(f"e2e CLI --device {d} at 160: rc {rc}")
        out[d] = cli_outputs(os.path.join(root, d), combo, 2, f"e2e CLI --device {d}")
    got, want = out["cuda"], out["cpu"]
    for k in ("mean_precision", "mean_recall", "mean_f1", "mAP50", "mAP50-95"):
        if not abs(float(got["summary"][k]) - float(want["summary"][k])) <= 1e-6:
            fail(f"e2e CLI card vs CPU: {k} {got['summary'][k]} vs {want['summary'][k]}")
    if [r["class"] for r in got["per_class"]] != [r["class"] for r in want["per_class"]]:
        fail("e2e CLI card vs CPU: per-class rows differ")
    for g, w in zip(got["per_class"], want["per_class"]):
        if any(g[k] != w[k] for k in ("tp", "fp", "fn")) or any(
                abs(float(g[k]) - float(w[k])) > 1e-6 for k in ("precision", "recall", "f1")):
            fail(f"e2e CLI card vs CPU: class {w['class']}: {g} vs {w}")
    if not 0 < float(want["summary"]["mAP50"]) < 1:
        fail(f"e2e CLI: a degenerate metric row {want['summary']}")
    row = {k: want["summary"][k] for k in ("mean_precision", "mean_recall", "mean_f1", "mAP50",
                                           "mAP50-95")}
    print(f"e2e CLI card == CPU at 160 (score noise {noise:.3g}, yolo_conf {yolo_conf:.6f}, "
          f"benchmark_conf {bench_conf:.6f}; {len(want['per_class'])} classes): {row}")
    return dict(score_noise=noise, yolo_conf=yolo_conf, benchmark_conf=bench_conf, row=row,
                classes=len(want["per_class"]))


def check_cli_full(dev, weights, img_dir: str, lbl_dir: str, root: str, extra, what: str,
                   want_counts) -> dict:
    """``apps/e2e.py::main`` at its defaults (``--dataset tt100k``: yolo_plus_v2
    + ShuffleNetV2-91, 640, B=8, 512 candidates, 64 detections, every anchor
    in the mAP pass; float32 dense unless ``extra`` says otherwise) on the
    frames of ``img_dir`` from disk; launch counts zeroed just before and
    read just after, each at least (or for 0, exactly) ``want_counts``.
    Then K1 and K2 against their plain versions on the inputs of the fused
    pass's first batch, in a pipeline built as the CLI builds its own
    (``e2e.build_pipeline`` on the same arguments;
    :func:`check_path_kernels`)."""
    out = os.path.join(root, what.replace(" ", "_"))
    argv = ["--input", img_dir, "--labels", lbl_dir, *weights, "--output", out, *extra]
    reset_launch_counts()
    t0 = time.perf_counter()
    rc = e2e_cli.main(argv)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    if rc != 0:
        fail(f"e2e CLI {what}: rc {rc}")
    if any((counts[k] < n) if n else counts[k] for k, n in want_counts.items()):
        fail(f"e2e CLI {what}: launch counts {counts}, expected at least {want_counts}")
    res = cli_outputs(out, "yolo_plus_v2+shufflenetv2", E2E_CLI_FULL_FRAMES, f"e2e CLI {what}")
    s = res["summary"]
    for k in CLI_METRICS:
        if not 0 <= float(s[k]) <= 1:
            fail(f"e2e CLI {what}: {k} = {s[k]}")
    args = e2e_cli.build_arg_parser().parse_args(argv)
    pipe = e2e_cli.build_pipeline(args)
    if isinstance(pipe, str):
        fail(f"e2e CLI {what}: build_pipeline refused: {pipe}")
    ev = PipelineEvaluator(pipe)
    first = sample_images(img_dir, args.num_samples, args.seed)[: args.batch_size]
    frames = torch.from_numpy(np.stack([ev._read_image(p) for p in first])).to(dev)
    kernel_checks = check_path_kernels(pipe, frames, None, f"e2e CLI {what}")
    del ev, pipe, frames
    result = dict(args=list(extra), seconds=seconds, fused_pass_fps=float(s["fps"]),
                  launches=counts, kernel_checks=kernel_checks,
                  row={k: float(s[k]) for k in CLI_METRICS})
    print(f"e2e CLI {what}: rc 0 in {seconds:.1f} s, fused pass "
          f"{result['fused_pass_fps']:.1f} FPS, launches {counts}")
    return result


def e2e_cli_phase(dev, root: str):
    """The deployed-artifact path: artifacts written on the card, the CLI
    card vs CPU, then the CLI at full width at its defaults and in bf16
    with the pyramid crop, on E2E_CLI_FULL_FRAMES frames of
    E2E_CLI_FULL_SIZE^2 from disk.  Returns (result, the files the convert
    phase starts from: the artifacts and the full-width frames, in
    ``root``)."""
    t0 = time.perf_counter()
    art = write_artifacts(dev, root)
    small = check_cli_small(dev, art, os.path.join(root, "small"))
    img_dir, lbl_dir = os.path.join(root, "full"), os.path.join(root, "full_labels")
    n, s = E2E_CLI_FULL_FRAMES, E2E_CLI_FULL_SIZE
    paths = write_jpegs(img_dir, [(s, s)] * n, torch.Generator().manual_seed(37))
    # the host's decode of every frame once (a CLI run decodes 89 frames:
    # warm-up 2 x 8, the fused pass 32 + 1 probe, a staged batch 8, the
    # mAP pass 32)
    import cv2

    t1 = time.perf_counter()
    for p in paths:
        cv2.imread(p)
    decode_s = time.perf_counter() - t1
    # labels from the artifacts' own detections at the CLI's benchmark_conf,
    # jittered, some dropped or relabelled (write_labels), in a pipeline
    # built as the CLI builds its own: the metric rows are then neither 0
    # nor 1, and the convert phase's comparison of rows holds something
    weights = ["--detector", art["pt"], "--classifier", art["pth"]]
    args = e2e_cli.build_arg_parser().parse_args(
        ["--input", img_dir, "--labels", lbl_dir, *weights, "--output", root])
    ev = PipelineEvaluator(e2e_cli.build_pipeline(args))
    frames = {p: ev._read_image(p) for p in paths}
    results = ev.run_images([frames[p] for p in paths], args.benchmark_conf)
    os.makedirs(lbl_dir)
    write_labels(lbl_dir, paths, frames, results, np.random.default_rng(38), 91)
    n_labels = sum(len(r["boxes"]) for r in results[:-1])
    if n_labels == 0:
        fail("e2e CLI: the artifacts detect nothing at benchmark_conf to label")
    del ev, frames
    dense = check_cli_full(dev, weights, img_dir, lbl_dir, root, [], "defaults",
                           {"nms_suppress": 1, "roi_crop_dense": 4, "roi_crop_pyramid": 0,
                            "roi_crop_pyramid_bf16": 0, "stem": 0})
    pallas = check_cli_full(dev, weights, img_dir, lbl_dir, root,
                            ["--dtype", "bfloat16", "--roi_impl", "pallas"], "bf16 pallas",
                            {"nms_suppress": 1, "roi_crop_dense": 0, "roi_crop_pyramid": 0,
                             "roi_crop_pyramid_bf16": 1, "stem": 0})
    result = dict(detector_rel_err=art["detector_rel_err"], small=small, full_dense=dense,
                  full_bf16_pallas=pallas, decode_once_s=decode_s, label_detections=n_labels,
                  seconds=time.perf_counter() - t0)
    print(f"e2e CLI phase (artifacts, card vs CPU, two full-width runs): "
          f"{result['seconds']:.1f} s; cv2 decodes the {n} frames once in {decode_s:.2f} s")
    return result, dict(art=art, img_dir=img_dir, lbl_dir=lbl_dir)

# --------------------------------------------------------------------- #
# the convert phase: emitted graphs, their interpreters, program export  #
# --------------------------------------------------------------------- #

CONVERT_CALLS = (  # (name, the convert CLI's argv beyond --input/--output/--device)
    ("det_ncnn", ["--arch", "yolo_plus_v2", "--num_classes", "1", "--emit", "ncnn"]),
    ("det_ncnn_fp16", ["--arch", "yolo_plus_v2", "--num_classes", "1", "--emit", "ncnn",
                       "--emit_dtype", "fp16"]),
    ("det_onnx", ["--arch", "yolo_plus_v2", "--num_classes", "1", "--emit", "onnx"]),
    ("det_openvino", ["--arch", "yolo_plus_v2", "--num_classes", "1", "--emit", "openvino"]),
    ("det_checkpoint", ["--arch", "yolo_plus_v2", "--num_classes", "1"]),
    ("cls_ncnn", ["--arch", "shufflenetv2", "--num_classes", "91", "--emit", "ncnn"]),
    ("cls_onnx", ["--arch", "shufflenetv2", "--num_classes", "91", "--emit", "onnx"]),
    ("cls_openvino", ["--arch", "shufflenetv2", "--num_classes", "91", "--emit", "openvino"]),
)


def graph_rel_err(got: np.ndarray, want: np.ndarray, detector: bool) -> float:
    """The largest difference relative to the largest magnitude of its part
    of ``want``: a detector's box rows and its score rows apart, a
    classifier's logits."""
    parts = ((slice(0, 4), slice(4, None)) if detector else (slice(None),))
    return max(float(np.abs(got[p] - want[p]).max() / max(float(np.abs(want[p]).max()), 1e-30))
               for p in parts)


def run_graph(kind: str, paths: dict, img: np.ndarray, device) -> np.ndarray:
    """An emitted graph through the port's interpreter of its format on one
    (3, S, S) image: (5, A) detector rows or (num_classes,) logits."""
    if kind == "ncnn":
        layers = ncnn_import.parse_ncnn_param(paths["param"])
        ncnn_import.read_ncnn_bin(layers, paths["bin"])
        return ncnn_import.run_ncnn_graph(layers, img, device=device)
    if kind == "onnx":
        nodes, inits, inputs, outputs = onnx_import.read_onnx_graph(paths["onnx"])
        blobs = onnx_import.run_onnx_graph(nodes, inits, {inputs[0]: img[None]}, device=device)
        return blobs[outputs[0]][0]
    return openvino_import.run_ir_graph(paths["xml"], paths["bin"], img[None], device=device)[0]


def graph_model(kind: str, paths: dict, detector: bool, dev):
    """The port's model with the weights the graph holds (read back by the
    port's importer of its format), float32 on ``dev``."""
    if detector:
        if kind == "ncnn":
            variables, _ = ncnn_import.convert_detector_ncnn(paths["param"], paths["bin"])
        elif kind == "onnx":
            variables = onnx_import.convert_detector_onnx(paths["onnx"], YOLO_PLUS_V2.depths)
        else:
            variables, _ = openvino_import.convert_detector_openvino(paths["xml"], paths["bin"])
        model = YoloLitePi(YOLO_PLUS_V2)
    else:
        if kind == "ncnn":
            variables, _ = ncnn_import.convert_classifier_ncnn(paths["param"], paths["bin"])
        elif kind == "onnx":
            variables, _ = onnx_import.convert_classifier_onnx_fused(paths["onnx"])
        else:
            variables, _ = openvino_import.convert_classifier_openvino_fused(paths["xml"],
                                                                            paths["bin"])
        model = build_classifier("shufflenetv2", 91, fused=True)
    model.load_state_dict(jax_to_state_dict(variables))
    return model.eval().to(dev)


def emitted_paths(out: str, name: str) -> dict:
    kind = name.split("_")[1]
    if kind == "ncnn":
        return {"param": os.path.join(out, "model.ncnn.param"),
                "bin": os.path.join(out, "model.ncnn.bin")}
    if kind == "onnx":
        return {"onnx": os.path.join(out, "model.onnx")}
    return {"xml": os.path.join(out, "model.xml"), "bin": os.path.join(out, "model.bin")}


def convert_phase(dev, cli: dict, files: dict, root: str) -> dict:
    """The reverse path: the convert CLI (``apps/convert.py::main``, in this
    process, ``--device cuda``) from the e2e CLI phase's ``.pt`` container
    and ``.pth`` emits the detector at 640 in NCNN fp32 and fp16, ONNX and
    OpenVINO, the ShuffleNetV2-91 classifier in all three, and writes the
    default checkpoint, each with rc 0.  Every emitted graph runs through
    its interpreter on the card (float32, TF32 off) and on the CPU, and the
    two agree within GRAPH_TOL; on the card it agrees within GRAPH_TOL with
    the port's model holding the weights the graph holds (read back by the
    port's importer), plus the DFL decode for a detector.  Then the e2e CLI
    at its defaults on the emitted fp32 NCNN pairs (the same weights as the
    .pt/.pth run, folded): its metric row within ROW_TOL of the e2e phase's
    row, K1 and K2 against their plain versions on its first batch, its
    launches counted.  Last, ``export_classifier`` at 64 and
    ``export_detector`` at 640 on the card: the loaded programs equal eager
    within PROGRAM_TOL."""
    t0 = time.perf_counter()
    art, out = files["art"], os.path.join(root, "convert")
    calls = {}
    for name, argv in CONVERT_CALLS:
        src = art["pt"] if name.startswith("det") else art["pth"]
        dst = os.path.join(out, name)
        t1 = time.perf_counter()
        rc = convert_cli.main([*argv, "--input", src, "--output", dst, "--device", dev.type])
        if rc != 0:
            fail(f"convert {name}: rc {rc}")
        calls[name] = time.perf_counter() - t1
    if not os.path.isfile(os.path.join(out, "det_checkpoint", "variables.pt")):
        fail("convert det_checkpoint: no checkpoint written")

    graphs, helpers = {}, load_test_module("torch_graph_helpers")
    for name, _ in CONVERT_CALLS:
        if name == "det_checkpoint":
            continue
        kind, detector = name.split("_")[1], name.startswith("det")
        paths = emitted_paths(os.path.join(out, name), name)
        size = 640 if detector else 64
        img = np.random.default_rng(41).uniform(0, 1, (3, size, size)).astype(np.float32)
        card = run_graph(kind, paths, img, dev)
        cpu = run_graph(kind, paths, img, "cpu")
        want = helpers.port_graph_output(graph_model(kind, paths, detector, dev), img, detector)
        errs = dict(card_vs_cpu=graph_rel_err(card, cpu, detector),
                    card_vs_model=graph_rel_err(card, want, detector))
        if card.shape != want.shape or not max(errs.values()) <= GRAPH_TOL:
            fail(f"convert {name}: interpreter {card.shape} vs model {want.shape}, relative "
                 f"errors {errs} (tolerance {GRAPH_TOL})")
        graphs[name] = dict(shape=list(card.shape), **errs)
        print(f"convert {name}: the emitted graph on the card == CPU and == the port's model "
              f"(relative {errs})")

    weights = ["--detector_param", os.path.join(out, "det_ncnn", "model.ncnn.param"),
               "--detector_bin", os.path.join(out, "det_ncnn", "model.ncnn.bin"),
               "--classifier", os.path.join(out, "cls_ncnn", "model.ncnn.param")]
    run = check_cli_full(dev, weights, files["img_dir"], files["lbl_dir"], root, [],
                         "emitted ncnn", {"nms_suppress": 1, "roi_crop_dense": 4,
                                          "roi_crop_pyramid": 0, "roi_crop_pyramid_bf16": 0,
                                          "stem": 0})
    diff = {k: abs(run["row"][k] - cli["full_dense"]["row"][k]) for k in CLI_METRICS}
    print(f"convert: e2e CLI on the emitted NCNN pairs vs on the .pt/.pth pair, metric row "
          f"differences {diff} (largest {max(diff.values())})")
    if not max(diff.values()) <= ROW_TOL:
        fail(f"convert: the emitted pairs' metric row differs by {max(diff.values())} > "
             f"{ROW_TOL}")

    x = torch.rand((2, 64, 64, 3), generator=torch.Generator(device=dev).manual_seed(42),
                   device=dev)
    clf = build_classifier("shufflenetv2", 91)
    clf.load_state_dict(jax_to_state_dict(art["cls_vars"]))
    clf = clf.eval().to(dev)
    prog = load_program(export_classifier("shufflenetv2", art["cls_vars"], 91, 64, 2, dev))
    with float32_exact():
        want = clf(x.permute(0, 3, 1, 2))
    got = prog(x)
    cls_err = float((got - want).abs().max() / want.abs().max())
    det = YoloLitePi(YOLO_PLUS_V2)
    det.load_state_dict(jax_to_state_dict(art["det_vars"]))
    det = det.eval().to(dev)
    prog = load_program(export_detector(YoloLitePi(YOLO_PLUS_V2), art["det_vars"], 640, 1, dev))
    x = torch.rand((1, 640, 640, 3), generator=torch.Generator(device=dev).manual_seed(43),
                   device=dev)
    with float32_exact():
        want = det(x.permute(0, 3, 1, 2))
    got = prog(x)
    det_err = max(float((got[k] - want[k]).abs().max() / want[k].abs().max())
                  for k in ("reg", "cls"))
    if not max(cls_err, det_err) <= PROGRAM_TOL:
        fail(f"convert: exported programs vs eager, relative {cls_err} (classifier), "
             f"{det_err} (detector) > {PROGRAM_TOL}")
    print(f"convert: exported programs == eager (classifier {cls_err:.3g}, detector "
          f"{det_err:.3g} relative)")
    result = dict(call_seconds=calls, graphs=graphs, e2e=run, row_diff=diff,
                  program_rel_err=dict(classifier=cls_err, detector=det_err),
                  seconds=time.perf_counter() - t0)
    print(f"convert phase (8 conversions, 7 graphs card vs CPU vs model, a full-width e2e "
          f"run, two program exports): {result['seconds']:.1f} s; launches {run['launches']}")
    return result


def run(dev) -> None:
    """Every phase on ``dev``; prints the kernels and e2e JSON lines and the
    card's name and power limit.  Raises on any failure."""
    smi = nvidia_smi()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    paths = build_kernels()
    print_resources(paths, smi, "before the timed windows")

    nms = check_nms(dev)
    roi = check_roi(dev)
    stem = check_stem(dev)
    acts = check_act(dev)
    for seed, h, w in SMALL_SCENES:
        check_small_pipeline(dev, seed, h, w)
    t0 = time.perf_counter()
    for variant, arch in ZOO_SMALL_PAIRS:
        for seed, h, w in SMALL_SCENES:
            check_small_pipeline(dev, seed, h, w, lambda d: zoo_pipeline(ZOO_SMALL, variant, arch, d),
                                 f"zoo {variant} + {arch}")
    zoo_seconds = time.perf_counter() - t0
    counts, run_counts, timings, runs = main_path(dev)
    detect = check_detect(dev)
    streaming = check_streaming(dev, runs[0][0], timings[0]["fps"])
    del runs
    t0 = time.perf_counter()
    zoo = zoo_path(dev)
    zoo_seconds += time.perf_counter() - t0
    print(f"zoo phase (small checks and full-width runs): {zoo_seconds:.1f} s")
    evaluation = eval_phase(dev)
    with tempfile.TemporaryDirectory() as root:
        cli, files = e2e_cli_phase(dev, root)
        convert = convert_phase(dev, cli, files, root)
    eval_counts = evaluation["full"]["launches"]
    eval_checks = evaluation["full"]["kernel_checks"]
    smi_after = nvidia_smi()
    print_resources(paths, smi_after, "after the timed windows")

    zoo_launches = {name: {f"{z['detector']}+{z['classifier']}": z["launches"][name] for z in zoo}
                    for name in ("nms_suppress", "roi_crop_dense", "stem", "silu_bf16",
                                 "sigmoid_bf16")}

    def entry(name, source, replaces, launches, r, err, shape, **extra):
        return dict(name=name, route="cuda", source=f"litepi_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=launches, max_abs_err=float(err), ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound"][0], bound_by=r["bound"][1],
                    library_ms=r.get("library_ms"), host_ms=r["host_ms"],
                    device_ms=r["device_ms"], shape=shape, **extra)

    # the eval phase's full-width launches go on the entry of their shape:
    # K1 at K=512 (detect and run_fused at 512 candidates), K2 dense at B=8
    # (2048x2048 frames)
    eval_launches = {"nms_suppress": 0, "nms_suppress_k512": eval_counts["nms_suppress"],
                     "roi_crop_dense": 0, "roi_crop_dense_b8": eval_counts["roi_crop_dense"],
                     "roi_crop_pyramid": eval_counts["roi_crop_pyramid"],
                     "roi_crop_pyramid_bf16": eval_counts["roi_crop_pyramid_bf16"],
                     "stem": eval_counts["stem"], "silu_bf16": eval_counts["silu_bf16"],
                     "sigmoid_bf16": eval_counts["sigmoid_bf16"]}
    # the e2e CLI phase's full-width launches (both runs, zeroed before each):
    # K1 at K=512, K2 dense at B=8 on 2048x2048 frames (the float32 run), K2
    # pyramid in its bf16 mode (the bf16 run)
    cli_runs = (cli["full_dense"], cli["full_bf16_pallas"])

    def cli_sum(key):
        return sum(r["launches"][key] for r in cli_runs)

    cli_launches = {"nms_suppress": 0, "nms_suppress_k512": cli_sum("nms_suppress"),
                    "roi_crop_dense": 0, "roi_crop_dense_b8": cli_sum("roi_crop_dense"),
                    "roi_crop_pyramid": cli_sum("roi_crop_pyramid"),
                    "roi_crop_pyramid_bf16": cli_sum("roi_crop_pyramid_bf16"),
                    "stem": cli_sum("stem"), "silu_bf16": cli_sum("silu_bf16"),
                    "sigmoid_bf16": cli_sum("sigmoid_bf16")}
    # the convert phase's full-width e2e run over the emitted NCNN pairs
    conv_counts = convert["e2e"]["launches"]
    convert_launches = {"nms_suppress": 0, "nms_suppress_k512": conv_counts["nms_suppress"],
                        "roi_crop_dense": 0, "roi_crop_dense_b8": conv_counts["roi_crop_dense"],
                        **{k: conv_counts[k] for k in ("roi_crop_pyramid", "roi_crop_pyramid_bf16",
                                                       "stem", "silu_bf16", "sigmoid_bf16")}}
    cli_checks = {"dense": cli["full_dense"]["kernel_checks"],
                  "pyramid_bf16": cli["full_bf16_pallas"]["kernel_checks"]}

    nms_at = "litepi_tpu/ops/pallas_nms.py:98"
    roi_at = "litepi_tpu/ops/pallas_roi.py:207"
    grid_sample = "F.grid_sample(border, align_corners=False)"
    k0, k1 = NMS_KS
    dense, dense_b8 = roi["dense"], roi["dense_b8"]
    pyr, pyr_bf16 = roi["pyramid"], roi["pyramid_bf16"]
    kernels = [
        # launches: K=64 on the four run_fused runs, K=512 on the detect run
        entry("nms_suppress", "nms.cu", nms_at, counts["nms_suppress"], nms[k0], 0,
              f"B={NMS_BATCH} K={k0}, 1 class", zoo_launches=zoo_launches["nms_suppress"],
              zoo_device_ms=zoo[0]["nms_device_ms"]),
        entry("nms_suppress_k512", "nms.cu", nms_at, detect["launches"]["nms_suppress"],
              nms[k1], 0, f"B={NMS_BATCH} K={k1}, 1 class",
              detect_device_ms=detect["nms_device_ms"],
              eval_nms_mismatches=eval_checks["nms_mismatches"],
              e2e_cli_nms_mismatches=sum(c["nms_mismatches"] for c in cli_checks.values()),
              convert_nms_mismatches=convert["e2e"]["kernel_checks"]["nms_mismatches"]),
        # dense launches per run: B=128 640x640, then B=8 1080x1920
        entry("roi_crop_dense", "roi.cu", roi_at, run_counts[0]["roi_crop_dense"], dense,
              dense["err"], "B={} D={} {}x{} out=64".format(*ROI_DENSE), library=grid_sample,
              library_max_abs_diff=dense["library_err"],
              zoo_launches=zoo_launches["roi_crop_dense"], zoo_device_ms=zoo[0]["roi_device_ms"],
              zoo_max_abs_err=max(z["kernel_checks"]["roi_max_abs_err"] for z in zoo),
              bf16_mode_max_abs_err=dense["bf16_err"], bf16_mode_ms=dense["bf16_ms"],
              bf16_mode_device_ms=dense["bf16_device_ms"]),
        entry("roi_crop_dense_b8", "roi.cu", roi_at, run_counts[1]["roi_crop_dense"],
              dense_b8, dense["err"], "B={} D={} {}x{} out=64".format(*ROI_PYRAMID),
              library=grid_sample, library_max_abs_diff=dense_b8["library_err"],
              eval_max_abs_err=eval_checks["roi_max_abs_err"],
              e2e_cli_max_abs_err=cli_checks["dense"]["roi_max_abs_err"],
              convert_max_abs_err=convert["e2e"]["kernel_checks"]["roi_max_abs_err"]),
        # the pyramid mode in float32 (the main path's float32 pallas run)
        entry("roi_crop_pyramid", "roi.cu", roi_at, counts["roi_crop_pyramid"], pyr, pyr["err"],
              "B={} D={} {}x{} out=64".format(*ROI_PYRAMID)
              + f", {pyr['levels']} levels built in advance, float32",
              with_levels_ms=pyr["with_levels_ms"],
              with_levels_device_ms=pyr["with_levels_device_ms"],
              with_levels_bound_ms=pyr["with_levels_bound"][0]),
        # and with bf16 rounding (the main path's bf16 pallas run)
        entry("roi_crop_pyramid_bf16", "roi.cu", roi_at, counts["roi_crop_pyramid_bf16"],
              pyr_bf16, pyr_bf16["err"], "B={} D={} {}x{} out=64".format(*ROI_PYRAMID)
              + f", {pyr['levels']} levels built in advance, bf16 rounding",
              e2e_cli_max_abs_err=cli_checks["pyramid_bf16"]["roi_max_abs_err"],
              e2e_cli_shape="B={} D={} 2048x2048, {} boxes".format(
                  *cli_checks["pyramid_bf16"]["roi_shape"],
                  cli_checks["pyramid_bf16"]["roi_boxes"])),
        entry("stem", "stem.cu", "litepi_tpu/ops/pallas_stem.py:111", counts["stem"], stem,
              stem["f32_err"], "B={} {}x{} C={}, bf16 out".format(*STEM_CASES[0]),
              library="F.conv2d(bf16 NCHW canvas, bias) + F.silu (cuDNN)",
              library_cast_ms=stem["cast_ms"], bf16_max_abs_err=stem["bf16_err"],
              bf16_max_ulps=stem["bf16_ulps"], zoo_launches=zoo_launches["stem"]),
        # port-only: JAX's bf16 SiLU / sigmoid steps, rounded as its StableHLO
        entry("silu_bf16", "act.cu", "none: port-only (flax nn.silu in bf16, "
              "litepi_tpu/models/layers.py:71)", counts["silu_bf16"], acts["silu_bf16"],
              acts["silu_bf16"]["max_abs_err"], "x".join(map(str, ACT_SILU_SHAPE)),
              library="F.silu (one rounding)",
              max_ulps=acts["silu_bf16"]["max_ulps"],
              mismatch_share=acts["silu_bf16"]["mismatch_share"],
              zoo_launches=zoo_launches["silu_bf16"]),
        # its path is the zoo's EfficientNet-B0 run (the main path has no gate)
        entry("sigmoid_bf16", "act.cu", "none: port-only (flax nn.sigmoid in bf16, "
              "litepi_tpu/models/efficientnet.py:55)",
              zoo_launches["sigmoid_bf16"]["yolov5n_legacy+efficientnet"], acts["sigmoid_bf16"],
              acts["sigmoid_bf16"]["max_abs_err"], "x".join(map(str, ACT_SIGMOID_SHAPE)),
              library="torch.sigmoid (one rounding)", max_ulps=acts["sigmoid_bf16"]["max_ulps"],
              mismatch_share=acts["sigmoid_bf16"]["mismatch_share"],
              zoo_launches=zoo_launches["sigmoid_bf16"]),
    ]
    for k in kernels:
        k["eval_launches"] = eval_launches[k["name"]]
        k["e2e_cli_launches"] = cli_launches[k["name"]]
        k["convert_launches"] = convert_launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"e2e": timings, "detect": detect, "streaming": streaming, "zoo": zoo,
                      "eval": evaluation, "e2e_cli": cli, "convert": convert,
                      "power": smi_after}))
    print(smi_after)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    run(dev)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
