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
   levels) and on an all-invalid batch; dense timed on both sizes (beside
   ``F.grid_sample``), pyramid on the second, both alone and, for
   pyramid, with the level build the main path runs; tolerance 1e-3 on
   0-255 values (both round each f32 product and sum once, in the same
   order; 0 is expected);
3. stem kernel vs ``stem_plain`` on B=128 640x640 C=16 (the serving stem),
   B=2 160x240 C=32, and the tile and pair edges: H in {2, 6, 80}, W in
   {2, 10, 642} (642: an odd output width), C in {16, 32} (weights as
   kernel parameters) and {3, 20, 256} (the generic path), on random,
   all-0 and all-255 frames: float32 out within 1e-4 (the tolerance
   tests/test_pallas_stem.py holds the Pallas kernel to), bfloat16 out
   within one bf16 ulp (1e-5 below 2^-10, where float32 sum noise is
   larger than an ulp); the serving shape timed, beside the cuDNN stem
   it replaces (conv + bias + SiLU on the bf16 canvas);
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
   crop, each on device frames and a device ``area_scale`` under
   ``torch.cuda.set_sync_debug_mode("error")``, so any host
   synchronisation fails the run.  Launch counts are zeroed just before
   each run and read just after; every kernel must have run;
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
   per image, score-descending, sync-free).

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
and 67 TFLOP/s float32), an ``{"e2e": ..., "zoo": ...}`` JSON line, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero.
Exits non-zero without a result when no CUDA device is present.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from litepi_tpu_torch.core.types import YOLOV8N, DetectorConfig, NMSConfig, PipelineConfig
from litepi_tpu_torch.data import native_loader
from litepi_tpu_torch.kernels import build as kbuild
from litepi_tpu_torch.kernels import launch_counts, reset_launch_counts
from litepi_tpu_torch.kernels.nms import nms_suppress_cuda
from litepi_tpu_torch.kernels.roi import roi_crop_cuda
from litepi_tpu_torch.kernels.stem import pack_stem_params, stem_cuda
from litepi_tpu_torch.models import build_classifier, detector_kwargs
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
from litepi_tpu_torch.pipeline import StreamingRunner, TwoStagePipeline
from litepi_tpu_torch.pipeline.streaming import area_scale_of, unmap_boxes
from litepi_tpu_torch.tools.nms_ab import nms_inputs
from litepi_tpu_torch.tools.roi_ab import roi_inputs, touched_bytes
from litepi_tpu_torch.tools.stage_split import cuda_ms, cuda_ms_windows, kernel_device_ms

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
# small pipeline scenes (seed, H, W): letterboxed, and canvas-sized for SMALL
# (the stem kernel's branch); each seed's frames have top candidate scores
# more than 20x the card-vs-CPU noise apart under SMALL's seed-3 weights
SMALL_SCENES = ((11, 200, 300), (44, 160, 160))
MAIN_RUNS = ((128, 640, 640, "dense"), (8, 1080, 1920, "dense"),
             (8, 1080, 1920, "pallas"))
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


def roi_error(frames, boxes, valid, out_size: int, mode: str):
    """The ROI kernel vs its plain version in one mode; returns (max abs
    error, kernel output, levels)."""
    h, w = int(frames.shape[1]), int(frames.shape[2])
    levels = [frames] if mode == "dense" else build_pyramid(frames, len(pyramid_scales(h, w)))
    got = roi_crop_cuda(levels, boxes, valid, out_size, EXACT_EXTENT, mode)
    want = crop_and_resize_plain(levels, boxes, valid, out_size)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= ROI_TOL:
        fail(f"ROI kernel ({mode}, {h}x{w}): max abs error {err} > {ROI_TOL}")
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
    err, got, _ = roi_error(frames, boxes, valid, s, "dense")
    result["dense"] = dict(err=err, **roi_timings(frames, boxes, valid, got, s))
    print(f"roi dense B={b} {h}x{w}: max err {err}, " + timing_text(result["dense"]))

    # 1080x1920: dense mode (the B=8 dense main run's shape) checked and
    # timed beside grid_sample, then pyramid mode with levels 1/4, 1/16 and
    # 1/64 on the same inputs
    b, d, h, w = ROI_PYRAMID
    frames, boxes, valid = roi_inputs(gen, b, d, h, w, dev)
    err_b8, got, _ = roi_error(frames, boxes, valid, s, "dense")
    result["dense"]["err"] = max(result["dense"]["err"], err_b8)
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
    with_levels_ms, with_levels_windows = median_ms(
        lambda: crop_and_resize_pyramid(frames, boxes, valid, s), 100
    )
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
                             with_levels_bound=with_levels_bound)
    print(f"roi pyramid ({len(levels)} levels): max err {err}, kernel {ms:.4f} ms "
          f"(windows {windows}), device {dev_ms:.4f} ms, host issue {host:.4f} ms, plain "
          f"{plain_ms:.3f} ms, levels+kernel {with_levels_ms:.4f} ms (windows "
          f"{with_levels_windows})")

    # an all-invalid batch: every slot zero, in both modes
    valid = torch.zeros_like(valid)
    for mode in ("dense", "pyramid"):
        got = roi_error(frames, boxes, valid, s, mode)[1]
        if bool(got.any()):
            fail(f"ROI kernel ({mode}): an all-invalid batch gave non-zero crops")
    print("roi: an all-invalid batch gives zero crops in both modes")
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
    """Full width, bf16, serving config.  Each run is issued under
    ``set_sync_debug_mode("error")``: a host synchronisation raises.
    Returns launch counts, timings and the runs (pipeline, frames, ...)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    runs = []
    for b, h, w, roi_impl in MAIN_RUNS:
        cfg = dataclasses.replace(SERVING, cls_crop_budget=4 * b, roi_impl=roi_impl)
        t0 = time.perf_counter()
        pipe = TwoStagePipeline.initialize(cfg, seed=0, dtype=torch.bfloat16, device=dev)
        frames = torch.randint(0, 256, (b, h, w, 3), generator=gen, device=dev, dtype=torch.uint8)
        area = torch.ones(b, device=dev)
        pipe.run_fused(frames, area_scale=area)  # warm-up (cuDNN algorithm selection)
        torch.cuda.synchronize()
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
        if n < 1:
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

def seeded_state(model, seed: int) -> dict:
    """``model``'s state with conv and linear weights N(0, ZOO_GAIN^2 /
    fan_in) from a ``torch.Generator`` seed, biases 0, BatchNorm at its
    identity init."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * (ZOO_GAIN / m.weight[0].numel() ** 0.5))
                if m.bias is not None:
                    m.bias.zero_()
    return model.state_dict()


def zoo_pipeline(cfg, variant: str, arch: str, device, dtype=torch.float32, seed: int = 7):
    """A pipeline on ``cfg`` with the ``variant`` detector injected
    (``detector_kwargs``) and the ``arch`` classifier, weights from
    :func:`seeded_state`."""
    cfg = dataclasses.replace(cfg, classifier_arch=arch)
    kw = detector_kwargs(variant, cfg, device)
    clf = build_classifier(arch, cfg.num_classifier_classes)
    return TwoStagePipeline(cfg, seeded_state(kw["det_model"], seed), seeded_state(clf, seed + 1),
                            dtype, device, **kw)


def check_zoo_kernels(pipe, frames, area, what: str) -> dict:
    """K1 and K2 on one zoo run's own inputs, the candidates and boxes its
    ``run_fused`` hands them (through the pipeline's stage methods), against
    their plain versions: the NMS keep mask bit-equal to
    ``suppress_sorted``, the dense crop within ROI_TOL of
    ``crop_and_resize_plain``.  At B=32, D=8 the crop kernel cuts each box
    into row bands sized from B*D, a shape the kernel checks do not reach."""
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
        roi_err = roi_error(frames, orig, v, cfg.cls_input_size, "dense")[0]
    result = dict(nms_valid=int(valid.sum()), nms_kept=int(keep.sum()), nms_mismatches=0,
                  roi_boxes=int(v.sum()), roi_max_abs_err=roi_err)
    print(f"{what}: on the run's inputs the NMS kernel equals suppress_sorted "
          f"({result['nms_kept']} of {result['nms_valid']} valid candidates kept) and the "
          "dense crop is within "
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
    want_counts = {"nms_suppress": 1, "roi_crop_dense": 1, "roi_crop_pyramid": 0, "stem": 0}
    runs = []
    for i, (variant, arch, b) in enumerate(ZOO_RUNS):
        cfg = dataclasses.replace(ZOO_SERVING, cls_crop_budget=4 * b)
        what = f"zoo {variant} + {arch} b={b}"
        pipe = zoo_pipeline(cfg, variant, arch, dev, torch.bfloat16, seed=10 * i)
        frames = torch.randint(0, 256, (b, s, s, 3), generator=gen, device=dev, dtype=torch.uint8)
        area = torch.ones(b, device=dev)
        pipe.run_fused(frames, area_scale=area)  # warm-up (cuDNN algorithm selection)
        out, counts = issue_sync_free(lambda: pipe.run_fused(frames, area_scale=area), what)
        if counts != want_counts:
            fail(f"{what}: launch counts {counts}, expected {want_counts}")
        check_outputs(out, b, cfg.crop_det_budget, s, s, cfg.num_classifier_classes, what)
        if not bool(out["valid"].any()):
            fail(f"{what}: no valid detection")
        kernel_checks = check_zoo_kernels(pipe, frames, area, what)
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
    if any(counts.values()):
        fail(f"zoo detect_candidates launched kernels: {counts}")
    print(f"zoo detect_candidates b={b}: {scores.shape[1]} candidates per image, sync-free")
    return dict(batch=b, candidates_per_image=int(scores.shape[1]), launches=counts,
                class_ids=sorted(int(c) for c in cls.unique()))


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
    smi_after = nvidia_smi()
    print_resources(paths, smi_after, "after the timed windows")

    zoo_launches = {name: {f"{z['detector']}+{z['classifier']}": z["launches"][name] for z in zoo}
                    for name in ("nms_suppress", "roi_crop_dense", "stem")}

    def entry(name, source, replaces, launches, r, err, shape, **extra):
        return dict(name=name, route="cuda", source=f"litepi_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=launches, max_abs_err=float(err), ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound"][0], bound_by=r["bound"][1],
                    library_ms=r.get("library_ms"), host_ms=r["host_ms"],
                    device_ms=r["device_ms"], shape=shape, **extra)

    nms_at = "litepi_tpu/ops/pallas_nms.py:98"
    roi_at = "litepi_tpu/ops/pallas_roi.py:207"
    grid_sample = "F.grid_sample(border, align_corners=False)"
    k0, k1 = NMS_KS
    dense, dense_b8, pyr = roi["dense"], roi["dense_b8"], roi["pyramid"]
    kernels = [
        # launches: K=64 on the three run_fused runs, K=512 on the detect run
        entry("nms_suppress", "nms.cu", nms_at, counts["nms_suppress"], nms[k0], 0,
              f"B={NMS_BATCH} K={k0}, 1 class", zoo_launches=zoo_launches["nms_suppress"],
              zoo_device_ms=zoo[0]["nms_device_ms"]),
        entry("nms_suppress_k512", "nms.cu", nms_at, detect["launches"]["nms_suppress"],
              nms[k1], 0, f"B={NMS_BATCH} K={k1}, 1 class",
              detect_device_ms=detect["nms_device_ms"]),
        # dense launches per run: B=128 640x640, then B=8 1080x1920
        entry("roi_crop_dense", "roi.cu", roi_at, run_counts[0]["roi_crop_dense"], dense,
              dense["err"], "B={} D={} {}x{} out=64".format(*ROI_DENSE), library=grid_sample,
              library_max_abs_diff=dense["library_err"],
              zoo_launches=zoo_launches["roi_crop_dense"], zoo_device_ms=zoo[0]["roi_device_ms"],
              zoo_max_abs_err=max(z["kernel_checks"]["roi_max_abs_err"] for z in zoo)),
        entry("roi_crop_dense_b8", "roi.cu", roi_at, run_counts[1]["roi_crop_dense"],
              dense_b8, dense["err"], "B={} D={} {}x{} out=64".format(*ROI_PYRAMID),
              library=grid_sample, library_max_abs_diff=dense_b8["library_err"]),
        entry("roi_crop_pyramid", "roi.cu", roi_at, counts["roi_crop_pyramid"], pyr, pyr["err"],
              "B={} D={} {}x{} out=64".format(*ROI_PYRAMID)
              + f", {pyr['levels']} levels built in advance",
              with_levels_ms=pyr["with_levels_ms"],
              with_levels_bound_ms=pyr["with_levels_bound"][0]),
        entry("stem", "stem.cu", "litepi_tpu/ops/pallas_stem.py:111", counts["stem"], stem,
              stem["f32_err"], "B={} {}x{} C={}, bf16 out".format(*STEM_CASES[0]),
              library="F.conv2d(bf16 NCHW canvas, bias) + F.silu (cuDNN)",
              library_cast_ms=stem["cast_ms"], bf16_max_abs_err=stem["bf16_err"],
              bf16_max_ulps=stem["bf16_ulps"], zoo_launches=zoo_launches["stem"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"e2e": timings, "detect": detect, "streaming": streaming, "zoo": zoo,
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
