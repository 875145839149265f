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
   NMSConfig default) on 1-class inputs, the serving detector's; above
   1,024 candidates (the greedy pass on a thread-block cluster per image,
   as at B=8, K=1,024) bit-equal at B=8 for K in {1,025, 2,000, 2,048,
   4,096, 8,400} with 1 and 91 classes, each case keeping and
   suppressing, and at K=1,100 on more images than the card holds
   clusters at once, and timed at (8, 2,000), (8, 8,400) and (128, 2,048)
   beside (8, 256) and (8, 1,024), each with its cluster shape;
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
   one-pass op; its bias mode and its BatchNorm mode (ACT_BN_SHAPES,
   channels last) bit-equal to their plain versions and to the passes
   they replace, timed beside them; YOLO-World's class-head GEMM
   (``csrc/vocab.cu``) against its plain version (cuDNN's class conv,
   ATen's bias add, the float32 copy) at VOCAB_EDGES and at the
   YOLO-World cell's three levels, every value within 2 bf16 ulps, the
   levels timed beside the passes they replace; then the path the GEMM
   serves, ``run_fused`` of the YOLO-World cell's pipeline (B=32 2048x2048
   frames at its 1280 input, the harness's seeded states), its launch
   counts zeroed just before one run and read just after: the GEMM 3 times
   and the max-sigmoid core 4 times, or the run fails; YOLOv9's ADown
   front-end kernel (``csrc/adown.cu``) bit-equal to ATen's chain (2x2
   average pool, chunk, 3x3/2 max pool) at ADOWN_EDGES and at the YOLOv9-E
   cell's ADown inputs, the cell's 8 calls timed beside that chain and
   beside the parent's path (the chain and the first half's dense copy);
   then ``run_fused`` of the YOLOv9-E cell's pipeline once: the kernel 8
   times and the fan-in 5 times, or the run fails;
4. the small pipeline (narrow detector, 10-class classifier, float32, TF32
   off) on the card vs the same pipeline on the CPU, where the kernels'
   plain versions run, at 200x300 frames (letterboxed) and at 160x160
   (canvas-sized: the stem kernel runs); then the same check for two zoo
   pairs at a 160 input, the detectors at full width: YOLOv11n + ResNet18
   and the anchor-based YOLOv5n + EfficientNet-B0 (its candidate decoder),
   with the stem kernel never launched; then the TF32 scope: a float32
   pipeline leaves the caller's TF32 flags (on, and off) as it found them
   around its construction and each entry point while its detector
   computes with TF32 off, and with the caller's TF32 on the small
   pipeline's card-vs-CPU check above still holds;
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
   within 1e-3 on the 2048x2048 frames); then the optimisation ladder
   (``bench/ladder.py``), L0-L4 on LADDER_FRAMES synthetic 640x640 frames,
   its launch counts zeroed before and read after (K1, K2 dense and K3 at
   least once), and K1, K2 and K3 against their plain versions on the L3
   pipeline's first batch;
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
   run the pyramid at B=8, D=64 over 4 levels of 2048x2048 frames); then
   the CLI at ``--dtype bfloat16 --max_candidates 8400`` (every
   prediction of the 640 grid through the device NMS: K1 at (8, 8,400),
   its launches counted by K, and apart those whose greedy pass ran on a
   cluster, which must include K=8,400) held the same way.  The full-width frames' labels come from the
   artifacts' own detections at ``benchmark_conf``, jittered, so that the
   metric rows are neither 0 nor 1;
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
   held against its plain version with the kernel checks (step 3); then
   the stream app (``apps/stream.py``, the reference's deployed app) at
   its defaults (bf16, 256 candidates) on phase 10's artifacts, video mode
   on an mp4 written here and folder mode, card vs CPU (its CSV rows:
   discrete columns equal, floats within both sides' bf16 drifts from
   float32, measured on the app's batches, plus the float32 tolerance
   card vs CPU, which the float32 programs must meet), its launches counted, K1
   and K2 against their plain versions on its first batch; and the report
   CLI (``apps/report.py``) over phase 10's output directory;
12. training: the act kernel's backward mode (the gradient of the bf16
   SiLU / sigmoid as ``jax.vjp`` rounds it) against its plain version,
   bit-equal, on ACT_CASES and at ACT_BWD_SHAPE, timed there beside the
   plain passes and torch's ``silu_backward``, and one EfficientNet-B0
   train step that must launch its sigmoid mode; one float32 detector
   train step (TF32 off) on the card vs the same step on the CPU (loss,
   every gradient leaf, the parameters after it); the bf16 train steps at
   full width timed on device batches (yolo_plus_v2 640x640 B=16 in ms
   and images/s, ShuffleNetV2-91 64x64 B=128 in ms); then the training
   CLIs in this process on data written here: the detector
   (``apps/train_detector.py``, yolo_plus_v2, 640, B=16, bf16, 2 epochs
   of 4 steps, validation through ``PipelineEvaluator``) as a user runs
   it, its epoch and validation seconds printed, with its launch counts
   zeroed just before and read just after (the bf16 SiLU and its
   backward and the NMS kernel at least once, the stem kernel never),
   finite losses and ``results.json`` with the JAX CLI's keys; under
   deterministic algorithms the same run again, and stopped after one
   epoch and resumed, the resumed run's last epoch's loss equal to the
   uninterrupted one's within 1e-5;
   the NMS kernel on validation's own inputs (the first validation batch,
   K=512, the last weights) bit-equal to ``suppress_sorted``; and the
   classifier (``apps/train_classifier.py``, ShuffleNetV2-91, 64, B=128,
   3 steps, validation); then the ablation CLI (``apps/ablation.py``):
   static + ``--bench`` over the reference grid at 640, ``--train`` for
   one variant and one epoch, its launches counted;
13. the baselines: Faster R-CNN-ResNet50-FPN (640, 1 foreground class,
   1,024 / 256 proposals) and SSD300-VGG16.  Card vs CPU (TF32 off,
   B=2, the CPU on the card's proposal choices): Faster R-CNN's float32
   forward at 640 (outputs within 1e-4 of their scale, each of the card's
   top-k picks a near-tie of the CPU's own, its RPN keep mask bit-equal to
   ``suppress_sorted``) and one float64 train step of each (Faster R-CNN
   at 320, SSD300 at 300, the sampling draws given): loss 1e-5 relative,
   gradient leaves 1e-3 of their scale, parameters 1e-5; each bf16 train
   step at B=8 timed on device batches (ms, host issue ms);
   both models' bf16 inference at B=8 (``detector_bench.make_harness``:
   ``infer`` + ``post``) issued under ``set_sync_debug_mode("error")``, the
   NMS kernel on that run's own inputs (the RPN's (8, 1,024) candidates,
   the final class-aware NMS at K=256 of each) bit-equal to
   ``suppress_sorted``, the RPN's call timed beside its bound and the plain
   version; the windowed crop (``roi_impl="windowed"``) card vs CPU on B=8
   1080x1920 frames in float32 and bf16 within ROI_TOL, and its dense
   fallback on 128x128 frames launching the ROI kernel once; then, with
   the launch counts zeroed before each and summed: the training CLI
   (``apps/train_baselines.py --device cuda``, B=8, bf16, the recipes'
   optimizers) for each model on synthetic labelled JPEGs, 2 epochs of 3
   steps with validation, ``results.json`` with the JAX CLI's keys; the
   detector bench (``bench/detector_bench.py --checkpoint``) on each run's
   ``last`` weights with the validation set's mAP columns; and the fair
   benchmark of all eight variants at batch 1 and 8 (bf16, warmup 5, timed
   20, pre / infer / post ms and device ms, FPS), each row printed as a
   JSON line with the card's name and power limit.  At torchvision's
   training budget of 2,000 proposals (K1 above 1,024): the float32
   forward's RPN keep mask card vs CPU on the card's top-k picks, and the
   training CLI with ``--pre_nms_topk 2000`` (2 epochs of 3 steps; K1's
   launches counted by K, and apart those on a cluster, which must include
   K=2,000).  The timed steps, the
   bf16 inference, the CLIs and the benches run under the TF32 flags of a
   fresh process (FRESH_TF32), as a user's process does;
14. data parallelism (``parallel/``, ``pipeline/serving.py``,
   ``data/distributed.py``): in this process one NCCL rank (a group of
   one) runs ``MeshServer.serve`` at the serving configuration (B=128
   640x640 device frames, bf16) under ``set_sync_debug_mode("error")``,
   its launch counts zeroed just before and read just after (K1, K2 dense
   and K3 once each), bit-equal to ``run_fused`` on the same frames and
   timed beside it (ms per batch, the median of 5 windows);
   ``StreamingRunner(server=...)`` over 4 such batches of canvases equal
   to the direct run + host unmap; the bf16 detector train step at full
   width (640, B=16) with the mesh, its first loss bit-equal to the step
   without one, the act kernel launched both ways.  Then
   ``parallel/multiprocess.py``'s flow at 1 and at 2 gloo ranks sharing
   the card (a correctness check, never a throughput number): float32
   served outputs' discrete values equal, floats within the float32
   tolerances, the train loss and parameter checksum within 1e-6
   relative.  Then the training CLI's launcher: ``--data_parallel 1`` on
   the card (validation's K1 at K=512 counted), ``--data_parallel`` beyond
   the visible cards exiting with rc 2, and 2 CPU ranks against 1, one
   step in the CLI's bf16 (the loss within one bf16 ulp).

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
phase's, ``convert_launches`` the convert phase's, ``train_launches`` the
training phase's, ``baseline_launches`` the baselines phase's; the act
kernel's backward has a row of its own, and K1 a row at the RPN's (8,
1,024), which holds K1's total over every K of the baselines phase,
split by K in ``baseline_launches_by_k``, and rows at (8, 256) (the
stream app), (8, 2,000) (the baseline CLI at ``--pre_nms_topk 2000``),
(8, 8,400) (the e2e CLI at ``--max_candidates 8400``) and (128, 2,048)
(a timing shape), the rows at 2,000 and 8,400 with
``greedy_cluster_launches``, their path's launches whose greedy pass ran
on a cluster (``nms_greedy_cluster_kernel``), and the RPN row with the
baselines phase's by K; ``stream_launches``, ``ladder_launches`` and
``ablation_launches`` are those paths' counts on the row of their shape,
``data_parallel_launches`` the data-parallel phase's), an
``{"e2e": ..., "zoo": ..., "eval": ..., "e2e_cli": ..., "convert": ...,
"training": ..., "baselines": ..., "stream": ..., "ladder": ...,
"ablation": ..., "data_parallel": ...}`` JSON line, and
last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero.
Exits non-zero without a result when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib.util
import json
import math
import os
import re
import shutil
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
    ablation_configs,
)
from litepi_tpu_torch.data import native_loader
from litepi_tpu_torch.evals.labels import sample_images
from litepi_tpu_torch.kernels import build as kbuild
from litepi_tpu_torch.kernels import launch_counts, reset_launch_counts
from litepi_tpu_torch.kernels.act import act_bf16_backward_cuda
from litepi_tpu_torch.kernels.nms import cluster_shape, nms_suppress_cuda
from litepi_tpu_torch.kernels.roi import roi_crop_cuda
from litepi_tpu_torch.kernels.stem import pack_stem_params, stem_cuda
from litepi_tpu_torch.kernels import vocab as vocab_ops
from litepi_tpu_torch.kernels.adown import adown_front_cuda, adown_front_plain
from litepi_tpu_torch.models import YoloLitePi, build_classifier, detector_kwargs
from litepi_tpu_torch.models.layers import ConvBN, runs_nchw
from litepi_tpu_torch.ops import act as act_ops
from litepi_tpu_torch.ops.anchors import make_anchors
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
from litepi_tpu_torch.tools.timing import (
    cuda_ms,
    cuda_ms_windows,
    kernel_device_ms,
    kernel_device_times,
)
from litepi_tpu_torch.train import (
    classifier_train_step,
    create_classifier_train_state,
    create_detector_train_state,
    detector_train_step,
)
from litepi_tpu_torch.train.losses import detection_loss
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
# K1 above 1,024 candidates (the greedy pass in global memory): bit-equal at
# B=8 (the plain version's (B, K, K) tensors bound the batch) at each K and
# class count; timed at the RPN's training budget (8, 2,000), every anchor
# of the 640 grid (8, 8,400) and the serving batch at 2,048
NMS_LARGE_BATCH, NMS_LARGE_KS, NMS_LARGE_CLASSES = 8, (1025, 2000, 2048, 4096, 8400), (1, 91)
NMS_LARGE_TIMED = ((8, 2000), (8, 8400), (128, 2048))
NMS_OVER_K = 1100  # the check with more clusters than the card holds at once
NMS_STREAM_TIMED = (8, 256)  # the stream app's budget at its batch
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
# the act kernel's bias mode at the litepi detector's largest SiLU conv
# output (backbone.down1, 3x3/2, 12 -> 24 channels, at the B=256 cell): the
# conv's input (B, C_in, H, W) and output channels
ACT_BIAS_CONV = (256, 12, 320, 320, 24)
# the act kernel's BatchNorm mode at the injected detectors' largest
# BatchNorm inputs, channels last as they run: YOLOv11n's stem output at the
# B=256 cell and YOLO12-L's (1280 input) at the B=32 cell; the plain version
# checked ACT_BN_CHUNK frames at a time (its float64 steps)
ACT_BN_SHAPES = ((256, 16, 320, 320), (32, 64, 640, 640))
ACT_BN_CHUNK = 16
# YOLO-World-v2-L's class head at the cell's B=32 and 1280 input: each
# level's BatchNorm output (B, K, H, W) into LVIS's VOCAB_NC classes, timed;
# and edges (B, K, H, W, nc): one class, part of a column tile, rows that
# end inside a row tile and cross images, K=64, one row, a column tile
# and one class more
VOCAB_LEVELS = ((32, 512, 160, 160), (32, 512, 80, 80), (32, 512, 40, 40))
VOCAB_NC = 1203
VOCAB_EDGES = ((1, 512, 8, 8, 1), (1, 512, 8, 8, 80), (3, 512, 7, 9, 80), (2, 64, 40, 40, 1203),
               (1, 512, 1, 1, 1203), (5, 128, 20, 20, 129))
BF16_FLOPS = 989e12  # H100 SXM bf16 on the tensor cores, dense, published
# YOLOv9-E's 8 ADown inputs at the cell's B=32 and 1280 input, in call order
# (down4, 6, 8; down20, 23, 26; down36, 39), timed together; and edges:
# odd sizes, the least map, one row of pooled output, C=16
ADOWN_CALLS = ((32, 256, 320, 320), (32, 512, 160, 160), (32, 1024, 80, 80)) * 2 + (
    (32, 256, 160, 160), (32, 512, 80, 80))
ADOWN_EDGES = ((2, 64, 33, 35), (3, 16, 2, 2), (1, 32, 5, 2), (2, 48, 4, 9), (1, 16, 2, 7))
DETECTOR_SILU_CONVS = 56  # the litepi detector's ConvBN calls after its stem
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
E2E_CLI_LARGE_K = 8400  # every anchor of the 640 grid: no top-K cut before NMS
ARTIFACT_TOL = 1e-4
CLI_METRICS = ("mean_precision", "mean_recall", "mean_f1", "mAP50", "mAP50-95")
# the convert phase: emitted graphs through their interpreters on the card
# vs the CPU and vs the port's model plus decode (float32, TF32 off),
# relative to each part's largest magnitude (boxes, scores, logits); the
# e2e run over the emitted NCNN pairs against the .pt/.pth run's metric
# row; the exported programs against eager, relative
GRAPH_TOL, ROW_TOL, PROGRAM_TOL = 1e-4, 1e-6, 1e-5


# the training phase: the act kernel's backward at a bf16 SiLU input of a
# B=16 training batch; the float32 step card vs CPU on a narrow ablation
# detector; the detector CLI at the reference's imgsz=640, batch=16 on
# synthetic 640x480 JPEG frames with YOLO labels, 2 epochs of 4 steps
# plus validation; the classifier CLI on 91 classes of 64x64 crops at
# batch 128; each train step timed over TRAIN_TIMED_STEPS steps a window
ACT_BWD_SHAPE = (16, 32, 320, 320)
TRAIN_SMALL = dataclasses.replace(
    ablation_configs(width_scales=(0.25,), extra=(), num_classes=3)[0], input_size=128)
TRAIN_DET_SIZE, TRAIN_DET_BATCH, TRAIN_MAX_GT = 640, 16, 64
TRAIN_DET_EPOCHS, TRAIN_DET_STEPS = 2, 4
TRAIN_DET_IMAGES, TRAIN_DET_VAL_IMAGES = 64, 32
TRAIN_CLS_BATCH, TRAIN_CLS_STEPS, TRAIN_CLS_CROPS = 128, 3, 3
TRAIN_TIMED_STEPS = 5
# the baselines phase: Faster R-CNN-ResNet50-FPN at the reference recipe
# (640, B=8, 1 foreground class, 1,024 / 256 proposals, bf16, SGD) and
# SSD300-VGG16 (300, B=8, AdamW), each through the training CLI for
# BASE_EPOCHS epochs of BASE_STEPS steps (cut from 30 epochs) on
# BASE_IMAGES synthetic JPEGs (BASE_VAL_IMAGES to validate); card vs CPU
# at B=2; the fair benchmark of every variant at BASE_BENCH_BATCHES; the
# windowed crop card vs CPU on B=8 1080x1920 frames
BASE_BATCH, BASE_CHECK_BATCH = 8, 2
BASE_EPOCHS, BASE_STEPS = 2, 3
BASE_IMAGES, BASE_VAL_IMAGES = 32, 8
BASE_BENCH_BATCHES = (1, 8)
BASE_TIMED_STEPS = 3
BASE_REL_TOL = 1e-4  # card vs CPU float32 forward, relative to each output's scale
BASE_STEP_SIZE = 320  # Faster R-CNN's float64 card-vs-CPU step (the CPU's float64 convs are slow)
BASE_LARGE_PRE_NMS = 2000  # torchvision's rpn_pre_nms_top_n_train: K1 above 1,024
# the stream app: video mode on an mp4 of STREAM_VIDEO_FRAMES of the e2e
# CLI phase's frames (a batch of 8 and a padded one), folder mode on
# STREAM_FOLDER_FRAMES of them; its conf in a
# score gap with at most STREAM_MAX_ABOVE detections per frame and at least
# STREAM_MIN_ABOVE in each mode; the float32 programs card vs CPU held to
# check_small_pipeline's tolerances (px, score, probability)
STREAM_VIDEO_FRAMES, STREAM_FOLDER_FRAMES = 12, 3
STREAM_MAX_ABOVE, STREAM_MIN_ABOVE = 8, 2
STREAM_F32_TOL = {"boxes": 1e-2, "det_scores": 1e-5, "cls_scores": 1e-4}
# the ladder on make_synthetic_dataset's 640x640 frames; the ablation's
# --train run on ABLATION_IMAGES frames
LADDER_FRAMES, LADDER_ITERATIONS = 16, 3
ABLATION_IMAGES = 16
# the data-parallel phase: MeshServer on one NCCL rank at the serving batch,
# a stream of that many batches through it, the bf16 train steps with the
# mesh; the 2-gloo-rank flow's limit (it spawns 1 and then 2 ranks)
DP_SERVE_BATCH, DP_STREAM_BATCHES, DP_TRAIN_STEPS = 128, 4, 2
DP_FLOW_TIMEOUT = 300.0
# PyTorch's TF32 flags (cuDNN, matmul) as a fresh process has them, read
# before any phase sets them: the baselines' timed train steps, CLIs and
# benches run under them, as a user's process does
FRESH_TF32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)

def fail(msg: str) -> None:
    raise RuntimeError(msg)


@contextlib.contextmanager
def fresh_tf32():
    """The TF32 flags of a fresh process (FRESH_TF32), the caller's given
    back on exit."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = FRESH_TF32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


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
        r = result[k] = nms_timing(*timed[k], thr, 200, 10)
        print(f"nms K={k}, 1 class: kernel {r['ms']:.4f} ms (windows {r['windows']}), device "
              f"{r['device_ms']:.4f} ms, host issue {r['host_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound'][0]:.5f} ms ({r['bound'][1]})")
    return result


def nms_timing(boxes, cls, valid, thr: float, iters: int, plain_iters: int) -> dict:
    """K1 on one input timed: ``ms`` (CUDA events, median of WINDOWS),
    ``device_ms`` (summed over the call's kernels, and each kernel apart),
    ``host_ms``, the plain version's ms and the bound."""
    kernel = lambda: nms_suppress_cuda(boxes, cls, valid, thr)  # noqa: E731
    ms, windows = median_ms(kernel, iters)
    times = kernel_device_times(kernel, iters, "nms_")
    seen = min((n for _, n in times.values()), default=0)
    if seen < iters // 2:
        fail(f"NMS device time: the trace shows {seen} of {iters} calls")
    plain_ms = cuda_ms(lambda: suppress_sorted(boxes, valid, cls, thr), plain_iters, 1)
    return dict(mismatches=0, ms=ms, windows=windows, host_ms=host_ms(kernel, iters),
                device_ms=sum(t for t, _ in times.values()),
                device_ms_by_kernel={re.search(r"nms_\w+", k).group(0): t
                                     for k, (t, _) in times.items()},
                plain_ms=plain_ms, bound=nms_bound(boxes, cls, valid), library_ms=None)


def check_nms_large(dev) -> dict:
    """K1 above 1,024 candidates: bit-equal to ``suppress_sorted`` at every K
    of NMS_LARGE_KS and class count of NMS_LARGE_CLASSES (B=8), each case
    both keeping and suppressing; timed at NMS_LARGE_TIMED on 1-class
    inputs, with the stream app's (8, 256) and the RPN's (8, 1,024) timed
    beside them."""
    thr = 0.45
    gen = torch.Generator(device=dev).manual_seed(40)
    n = 0
    for k in NMS_LARGE_KS:
        for num_classes in NMS_LARGE_CLASSES:
            boxes, cls, valid = nms_inputs(gen, NMS_LARGE_BATCH, k, num_classes, dev)
            got = nms_suppress_cuda(boxes, cls, valid, thr)
            want = suppress_sorted(boxes, valid, cls, thr)
            torch.cuda.synchronize()
            mismatches = int((got != want).sum())
            if mismatches:
                fail(f"NMS kernel K={k}, {num_classes} classes: {mismatches} keep bits differ "
                     "from the plain version")
            if not (0 < int(got.sum()) < int(valid.sum())):
                fail(f"NMS check K={k}: inputs suppress nothing or keep nothing")
            n += 1
            del boxes, cls, valid, got, want
    print(f"nms above 1,024: bit-equal to suppress_sorted in {n} cases (B={NMS_LARGE_BATCH}, "
          f"K {NMS_LARGE_KS}, classes {NMS_LARGE_CLASSES})")
    # more clusters than the card holds at once (B * blocks > 132): the
    # clusters past its capacity wait for a free place
    b = 16
    while True:
        blocks, capacity = cluster_shape(b, NMS_OVER_K)
        if b > capacity:
            break
        b = capacity + 1
    boxes, cls, valid = nms_inputs(gen, b, NMS_OVER_K, 1, dev)
    mismatches = int((nms_suppress_cuda(boxes, cls, valid, thr)
                      != suppress_sorted(boxes, valid, cls, thr)).sum())
    if mismatches or b * blocks <= 132:
        fail(f"NMS kernel B={b} K={NMS_OVER_K} on {b} clusters of {blocks} blocks (the card "
             f"holds {capacity}): {mismatches} keep bits differ from the plain version")
    result = {"oversubscribed": dict(batch=b, k=NMS_OVER_K, cluster_blocks=blocks,
                                     clusters_held_at_once=capacity, mismatches=0)}
    print(f"nms B={b} K={NMS_OVER_K}: {b} clusters of {blocks} blocks, the card holds "
          f"{capacity} at once: bit-equal to suppress_sorted")
    del boxes, cls, valid
    for b, k in (NMS_STREAM_TIMED, (8, 1024), *NMS_LARGE_TIMED):
        boxes, cls, valid = nms_inputs(gen, b, k, 1, dev)
        r = nms_timing(boxes, cls, valid, thr, 50 if k > 1024 else 200, 3)
        r["cluster_blocks_and_capacity"] = cluster_shape(b, k)
        result[f"{b}x{k}"] = r
        print(f"nms B={b} K={k}, 1 class: kernel {r['ms']:.4f} ms (windows {r['windows']}), "
              f"device {r['device_ms']:.4f} ms {r['device_ms_by_kernel']}, host issue "
              f"{r['host_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound'][0]:.5f} ms ({r['bound'][1]})")
        del boxes, cls, valid
    torch.cuda.empty_cache()
    return result


class K1ByK:
    """Counts K1's launches by K while it is entered, and apart those whose
    greedy pass ran on a thread-block cluster: the kernel module's wrapper
    is replaced by one that adds what the launch counters moved by to the
    call's K."""

    def __init__(self):
        from litepi_tpu_torch.kernels import nms as nms_kernel

        self.module, self.real = nms_kernel, nms_kernel.nms_suppress_cuda
        self.by_k, self.cluster_by_k = {}, {}

    def __enter__(self):
        def tallied(boxes, *args):
            before = launch_counts()
            keep = self.real(boxes, *args)
            after, k = launch_counts(), int(boxes.shape[1])
            for tally, key in ((self.by_k, "nms_suppress"),
                               (self.cluster_by_k, "nms_greedy_cluster")):
                if after[key] > before[key]:
                    tally[k] = tally.get(k, 0) + after[key] - before[key]
            return keep

        self.module.nms_suppress_cuda = tallied
        return self

    def __exit__(self, *exc):
        self.module.nms_suppress_cuda = self.real


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
    out["silu_bias_bf16"] = check_act_bias(dev)
    out["bn_silu_bf16"] = check_act_bn(dev)
    return out


def check_act_bias(dev) -> dict:
    """The bias mode (``silu(y, bias)``) at ACT_BIAS_CONV's conv output, in
    NCHW and channels last: bit-equal to its plain version and to the two
    passes it replaces (the biased conv, whose bias cuDNN leaves to ATen's
    bf16 add, then the SiLU kernel), or the run fails.  Timed beside those
    two passes (the add and the SiLU pass apart) and its bytes bound: the
    conv output and the result, 2 bytes a value, and the bias read once.
    First, every pair of bf16 values (x, bias) against the plain version
    (NaNs equal): 2,048 channels of all 65,536 values at a time, each
    channel's bias another value."""
    every = torch.arange(-32768, 32768, dtype=torch.int32, device=dev).to(torch.int16).view(
        torch.bfloat16)
    x = every.view(1, 1, 256, 256).expand(1, 2048, 256, 256).contiguous()
    bad = 0
    with torch.inference_mode():
        for c0 in range(0, every.numel(), 2048):
            got = act_ops.silu(x, every[c0:c0 + 2048])
            want = act_ops.silu_bias_bf16_plain(x, every[c0:c0 + 2048])
            bad += int(((got.view(torch.int16) != want.view(torch.int16))
                        & ~(got.isnan() & want.isnan())).sum())
    if bad:
        fail(f"silu_bias_bf16: {bad} of 2^32 (x, bias) pairs differ from the plain version")
    print("silu_bias_bf16: every (x, bias) pair of bf16 values equals the plain version")
    del every, x, got, want
    gen = torch.Generator(device=dev).manual_seed(12)
    b, c_in, h, w, c = ACT_BIAS_CONV
    x = (torch.randn((b, c_in, h, w), generator=gen, device=dev) * 2).bfloat16()
    weight = (torch.randn((c, c_in, 3, 3), generator=gen, device=dev)
              / (9 * c_in) ** 0.5).bfloat16()
    bias = (torch.randn(c, generator=gen, device=dev) * 2).bfloat16()
    out = {"every_pair_mismatches": bad}
    for layout in ("nchw", "channels_last"):
        xin = x if layout == "nchw" else x.contiguous(memory_format=torch.channels_last)
        with torch.inference_mode():
            y = F.conv2d(xin, weight, None, 2, 1)
            got = act_ops.silu(y, bias)
            wants = {"its plain version": act_ops.silu_bias_bf16_plain(y, bias),
                     "the biased conv and the SiLU pass": act_ops.silu(
                         F.conv2d(xin, weight, bias, 2, 1))}
        torch.cuda.synchronize()
        what = f"silu_bias_bf16 {layout} {tuple(y.shape)}"
        for name, want in wants.items():
            bad = int((got.view(torch.int16) != want.view(torch.int16)).sum())
            if bad or got.stride() != y.stride():
                fail(f"{what}: {bad} of {got.numel()} elements differ from {name}, "
                     f"strides {got.stride()} vs {y.stride()}")
        del got, wants, xin
        n = y.numel()
        fn = lambda: act_ops.silu(y, bias)  # noqa: E731
        add = lambda: y + bias[:, None, None]  # noqa: E731
        ms, windows = median_ms(fn, 20)
        r = dict(shape=list(y.shape), layout=layout, ms=ms, windows=windows,
                 host_ms=host_ms(fn, 20), device_ms=device_ms(fn, 20, "act_bias_vec_kernel"),
                 plain_ms=cuda_ms(lambda: act_ops.silu_bias_bf16_plain(y, bias), 5),
                 two_pass_ms=cuda_ms(lambda: act_ops.silu(add()), 20),
                 add_device_ms=device_ms(add, 20, "elementwise_kernel"),
                 silu_device_ms=device_ms(lambda: act_ops.silu(y), 20, "act_vec_kernel"),
                 mismatches=0, elements=n, max_abs_err=0.0,
                 # y read once and the result written once, 2 bytes each, the
                 # bias once; the add and SiLU's five steps per value
                 bound=bound(4 * n + 2 * c, 6 * n))
        print(f"{what}: {ms:.4f} ms (windows {windows}), device {r['device_ms']:.4f} ms, host "
              f"issue {r['host_ms']:.4f} ms; the two passes it replaces {r['two_pass_ms']:.4f} "
              f"ms (device: add {r['add_device_ms']:.4f}, SiLU {r['silu_device_ms']:.4f}); "
              f"plain {r['plain_ms']:.4f} ms; bound {r['bound'][0]:.4f} ms ({r['bound'][1]}); "
              "bit-equal to the plain version and to the biased conv + SiLU")
        out[layout] = r
        del y
    return out


def check_act_bn(dev) -> dict:
    """The BatchNorm mode (``batch_norm_act``) at ACT_BN_SHAPES, channels
    last, with SiLU and alone: bit-equal to its plain version and to the
    two passes it replaces (ATen's eval BatchNorm with float32 statistics,
    then the SiLU kernel), or the run fails.  The mode with SiLU timed
    beside those two passes, each of their kernels' device time, and its
    bytes bound: the input and the result, 2 bytes a value, and each
    channel's four float32 numbers once."""
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {}
    for shape in ACT_BN_SHAPES:
        n, c = shape[0] * shape[1] * shape[2] * shape[3], shape[1]
        x = (torch.randn(shape, generator=gen, device=dev) * 2).bfloat16().contiguous(
            memory_format=torch.channels_last)
        bn = torch.nn.BatchNorm2d(c, eps=1e-3).to(dev).eval()
        with torch.no_grad():
            bn.running_mean.copy_(torch.randn(c, generator=gen, device=dev) * 0.5)
            bn.running_var.copy_(torch.rand(c, generator=gen, device=dev) * 2 + 0.05)
            bn.weight.copy_(torch.randn(c, generator=gen, device=dev) * 0.5 + 1)
            bn.bias.copy_(torch.randn(c, generator=gen, device=dev) * 0.5)
        state = (bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)
        what = f"bn_act_bf16 channels_last {shape}"
        for with_silu in (True, False):
            plain = act_ops.batch_norm_silu_bf16_plain if with_silu else \
                act_ops.batch_norm_bf16_plain
            with torch.inference_mode():
                got = act_ops.batch_norm_act(x, *state, with_silu)
                two = act_ops.silu(bn(x)) if with_silu else bn(x)
                bad = {"ATen's BatchNorm and the act": int((got.view(torch.int16)
                                                           != two.view(torch.int16)).sum())}
                del two
                bad["its plain version"] = sum(
                    int((got[i:i + ACT_BN_CHUNK].view(torch.int16) != plain(
                        x[i:i + ACT_BN_CHUNK], *state).view(torch.int16)).sum())
                    for i in range(0, shape[0], ACT_BN_CHUNK))
            torch.cuda.synchronize()
            if any(bad.values()) or got.stride() != x.stride():
                fail(f"{what} silu={with_silu}: elements that differ {bad}, strides "
                     f"{got.stride()} vs {x.stride()}")
            del got
        fn = lambda: act_ops.batch_norm_act(x, *state, True)  # noqa: E731
        two_pass = lambda: act_ops.silu(bn(x))  # noqa: E731
        with torch.inference_mode():
            ms, windows = median_ms(fn, 20)
            r = dict(shape=list(shape), layout="channels_last", ms=ms, windows=windows,
                     host_ms=host_ms(fn, 20), device_ms=device_ms(fn, 20, "bn_act_vec_kernel"),
                     plain_ms=cuda_ms(lambda: [act_ops.batch_norm_silu_bf16_plain(
                         x[i:i + ACT_BN_CHUNK], *state) for i in range(0, shape[0],
                                                                      ACT_BN_CHUNK)], 1, 0),
                     library_ms=cuda_ms(two_pass, 20),
                     bn_device_ms=device_ms(lambda: bn(x), 20, "batch_norm_transform_input"),
                     silu_device_ms=device_ms(lambda: act_ops.silu(x), 20, "act_vec_kernel"),
                     mismatches=0, elements=n, max_abs_err=0.0,
                     # x read once and the result written once, 2 bytes
                     # each, the channels' records once; the BatchNorm's
                     # three operations and SiLU's five per value
                     bound=bound(4 * n + 16 * c, 8 * n))
        print(f"{what}: {ms:.4f} ms (windows {windows}), device {r['device_ms']:.4f} ms, host "
              f"issue {r['host_ms']:.4f} ms; ATen's BatchNorm and the SiLU pass it replaces "
              f"{r['library_ms']:.4f} ms (device: BatchNorm {r['bn_device_ms']:.4f}, SiLU "
              f"{r['silu_device_ms']:.4f}); plain {r['plain_ms']:.4f} ms; bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]}); with SiLU and alone bit-equal to the "
              "plain version and to ATen's BatchNorm + the act")
        out["x".join(map(str, shape))] = r
        del x
    return out


def vocab_inputs(gen, b: int, k: int, h: int, w: int, nc: int, dev):
    x = torch.randn((b, k, h, w), generator=gen, device=dev).bfloat16().contiguous(
        memory_format=torch.channels_last)
    weight = (torch.randn((nc, k, 1, 1), generator=gen, device=dev) * 3 / k ** 0.5).bfloat16()
    bias = torch.randn(nc, generator=gen, device=dev).bfloat16()
    return x, weight, bias


def vocab_compare(got, want, x, weight) -> dict:
    """The kernel's logits ``got`` against the plain version's ``want``
    ((B, H*W, nc) float32 each, bf16 values), image by image, each error
    in bf16 ulps of max(|want|, |c|), c the conv's bf16 output before its
    bias.  The two float32 sums differ only in their order, by far less
    than a bf16 ulp of the sum, so c's rounding moves by one ulp at most
    and the bias add's rounding by one more: every value must lie within 2.
    Returns the values compared, those not bit-equal, the largest error and
    how many lie more than 1 and more than 2 ulps off."""
    r = dict(elements=0, differ=0, max_abs_err=0.0, max_ulps=0.0, over_1_ulp=0, over_2_ulps=0)
    for i in range(x.shape[0]):
        c = F.conv2d(x[i:i + 1], weight).permute(0, 2, 3, 1).reshape(got.shape[1:]).float()
        err = (got[i] - want[i]).abs()
        unit = torch.ldexp(torch.ones_like(c), torch.frexp(
            torch.maximum(want[i].abs(), c.abs())).exponent - 8)
        r["elements"] += err.numel()
        r["differ"] += int((err > 0).sum())
        r["max_abs_err"] = max(r["max_abs_err"], float(err.max()))
        r["max_ulps"] = max(r["max_ulps"], float((err / unit).max()))
        r["over_1_ulp"] += int((err > unit).sum())
        r["over_2_ulps"] += int((err > 2 * unit).sum())
        del c, err, unit
    return r


def check_vocab(dev) -> dict:
    """The class-head GEMM (``kernels/vocab.py``) against its plain version
    (cuDNN's class conv, ATen's bias add, the float32 copy): at
    VOCAB_EDGES, each into rows 5 .. 5 + H*W - 1 of a NaN-filled (B, H*W +
    7, nc) tensor whose other rows must stay NaN, and at the cell's three
    levels (VOCAB_LEVELS, nc = VOCAB_NC) into one (B, A, nc) tensor; every
    value within :func:`vocab_compare`'s 2 bf16 ulps or the run fails.  The
    three levels timed together beside the passes they replace
    (``library_ms``), each level's device time, and the bytes bound: x
    read once, the float32 logits written once, the weight once."""
    gen = torch.Generator(device=dev).manual_seed(24)
    with torch.inference_mode():
        for b, k, h, w, nc in VOCAB_EDGES:
            x, weight, bias = vocab_inputs(gen, b, k, h, w, nc, dev)
            outs = [torch.full((b, h * w + 7, nc), float("nan"), device=dev) for _ in range(2)]
            vocab_ops.vocab_logits_cuda(x, weight, bias, outs[0], 5)
            vocab_ops.vocab_logits_plain(x, weight, bias, outs[1], 5)
            torch.cuda.synchronize()
            what = f"vocab_gemm ({b}, {k}, {h}, {w}) nc={nc}"
            if not (outs[0][:, :5].isnan().all() and outs[0][:, 5 + h * w:].isnan().all()):
                fail(f"{what}: wrote outside its rows")
            r = vocab_compare(outs[0][:, 5:5 + h * w], outs[1][:, 5:5 + h * w], x, weight)
            if r["over_2_ulps"]:
                fail(f"{what}: {r}")
            print(f"{what}: {r}")
        levels = [vocab_inputs(gen, *shape, VOCAB_NC, dev) for shape in VOCAB_LEVELS]
        b = VOCAB_LEVELS[0][0]
        sizes = [h * w for _, _, h, w in VOCAB_LEVELS]
        a0s = [sum(sizes[:i]) for i in range(len(sizes))]
        got = torch.empty((b, sum(sizes), VOCAB_NC), device=dev)
        want = torch.empty_like(got)

        def run(fn, out):
            for (x, weight, bias), a0 in zip(levels, a0s):
                fn(x, weight, bias, out, a0)

        reset_launch_counts()
        run(vocab_ops.vocab_logits_cuda, got)
        if launch_counts()["vocab_gemm"] != len(levels):
            fail(f"vocab_gemm: {launch_counts()['vocab_gemm']} launches for {len(levels)} levels")
        run(vocab_ops.vocab_logits_plain, want)
        torch.cuda.synchronize()
        per_level = []
        total = dict(elements=0, differ=0, max_abs_err=0.0, max_ulps=0.0, over_1_ulp=0,
                     over_2_ulps=0)
        for (x, weight, bias), a0, n in zip(levels, a0s, sizes):
            r = vocab_compare(got[:, a0:a0 + n], want[:, a0:a0 + n], x, weight)
            for key, v in r.items():
                total[key] = max(total[key], v) if key.startswith("max") else total[key] + v
            ms = device_ms(lambda: vocab_ops.vocab_logits_cuda(x, weight, bias, got, a0), 10,
                           "vocab_gemm_kernel")
            m = x.numel() // x.shape[1]
            per_level.append(dict(shape=list(x.shape), device_ms=ms, bound=vocab_bound(
                m, x.shape[1], VOCAB_NC), errors=r))
            print(f"vocab_gemm level {tuple(x.shape)}: device {ms:.4f} ms, bound "
                  f"{per_level[-1]['bound'][0]:.4f} ms; {r}")
        if total["over_2_ulps"]:
            fail(f"vocab_gemm at the cell's levels: {total}")
        fn = lambda: run(vocab_ops.vocab_logits_cuda, got)  # noqa: E731
        ms, windows = median_ms(fn, 10)
        m = sum(b * n for n in sizes)
        # the plain version is the three passes the kernel replaces
        library_ms = cuda_ms(lambda: run(vocab_ops.vocab_logits_plain, want), 5)
        r = dict(shape=[list(s) for s in VOCAB_LEVELS], nc=VOCAB_NC, ms=ms, windows=windows,
                 host_ms=host_ms(fn, 10), device_ms=sum(p["device_ms"] for p in per_level),
                 levels=per_level, library_ms=library_ms, plain_ms=library_ms,
                 bound=vocab_bound(m, VOCAB_LEVELS[0][1], VOCAB_NC),
                 mismatch_share=total["differ"] / total["elements"], **total)
        print(f"vocab_gemm, the cell's three levels: {ms:.4f} ms (windows {windows}), device "
              f"{r['device_ms']:.4f} ms, host issue {r['host_ms']:.4f} ms; cuDNN's class conv, "
              f"ATen's bias add and the float32 copy {r['library_ms']:.4f} ms; bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]}); {total['differ']} of "
              f"{total['elements']} values not bit-equal, at most {total['max_ulps']:.3g} bf16 "
              f"ulps ({total['over_1_ulp']} over 1, {total['over_2_ulps']} over 2)")
        del got, want, levels
    return r


def vocab_bound(m: int, k: int, nc: int):
    """(bound ms, by) of the class-head GEMM: x (m, k) bf16 read once, the
    weight and bias once, the (m, nc) float32 logits written once; 2 m k nc
    operations on the bf16 tensor cores."""
    t_bytes = (2 * m * k + 2 * nc * (k + 1) + 4 * m * nc) / HBM_BYTES_PER_S
    t_ops = 2 * m * k * nc / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


WORLD_CELL = "yoloworldv2l.card-b32-2048"  # the YOLO-World cell of the benchmark
WORLD_SEED = 24


def world_path(dev) -> dict:
    """:func:`cell_path` of WORLD_CELL; fails unless the class head ran as
    its 3 GEMMs and the core 4 times."""
    r = cell_path(dev, WORLD_CELL, WORLD_SEED)
    counts = r["launches"]
    if counts["vocab_gemm"] != 3 or counts["maxsig"] != 4:
        fail(f"{WORLD_CELL} run_fused: vocab_gemm {counts['vocab_gemm']} (want 3), maxsig "
             f"{counts['maxsig']} (want 4)")
    return r


def adown_bound(shapes):
    """(bound ms, by) of ADown front ends on inputs of ``shapes``: the
    benchmark's count (``cardbench/adown_counts.py``: each input read once,
    both halves' outputs written once, in bf16)."""
    from cardbench import adown_counts

    return bound(sum(adown_counts.bytes_of(s) for s in shapes), 0)


def adown_equal(x, what: str) -> None:
    """The kernel's two outputs against the plain chain's on ``x``, bit for
    bit (NaNs too), each dense channels last; fails otherwise."""
    got, want = adown_front_cuda(x), adown_front_plain(x)
    torch.cuda.synchronize()
    for name, g, w in zip(("x1", "x2p"), got, want):
        if g.shape != w.shape or not g.is_contiguous(memory_format=torch.channels_last):
            fail(f"adown {what}: {name} {tuple(g.shape)} strides {g.stride()}, want "
                 f"{tuple(w.shape)} dense channels last")
        differ = int((g.contiguous().view(torch.int16) != w.contiguous().view(torch.int16)).sum())
        if differ:
            fail(f"adown {what}: {name} differs from ATen's chain in {differ} values")


def check_adown(dev) -> dict:
    """YOLOv9's ADown front end (``kernels/adown.py``) against ATen's chain
    on the card, bit for bit: at ADOWN_EDGES with NaN and both infinities
    planted, and at each distinct input of ADOWN_CALLS.  Then the cell's 8
    calls timed together (CUDA events; each shape's kernel time from the
    profiler) beside the plain chain (``plain_ms``) and beside what the
    parent's path ran (``library_ms``: ATen's average pool, its first half
    made dense as cuDNN made it for ``cv1``, the max pool with its copy of
    the second half and its indices), and the bytes bound."""
    gen = torch.Generator(device=dev).manual_seed(26)
    specials = torch.tensor([float("nan"), float("inf"), float("-inf")], device=dev)
    with torch.inference_mode():
        for shape in ADOWN_EDGES:
            x = torch.randn(shape, generator=gen, device=dev).bfloat16()
            flat = x.view(-1)
            idx = torch.randint(0, flat.numel(), (max(3, flat.numel() // 50),), generator=gen,
                                device=dev)
            flat[idx] = specials.repeat(idx.numel() // 3 + 1)[:idx.numel()].bfloat16()
            adown_equal(x.contiguous(memory_format=torch.channels_last), f"edge {shape}")
        inputs = {}
        for shape in ADOWN_CALLS:
            if shape not in inputs:
                inputs[shape] = (torch.randn(shape, generator=gen, device=dev) * 4).bfloat16(
                ).contiguous(memory_format=torch.channels_last)
                adown_equal(inputs[shape], f"at {shape}")
        print(f"adown: bit-equal to ATen's chain at {len(ADOWN_EDGES)} edges (NaN, inf planted) "
              f"and the cell's {len(inputs)} input shapes")
        xs = [inputs[shape] for shape in ADOWN_CALLS]
        per_shape = []
        for shape, x in inputs.items():
            ms = device_ms(lambda: adown_front_cuda(x), 10, "adown_front_kernel")
            b = adown_bound([shape])
            per_shape.append(dict(shape=list(shape), device_ms=ms, bound_ms=b[0],
                                  roofline=100 * b[0] / ms))
            print(f"adown {shape}: device {ms:.4f} ms, bound {b[0]:.4f} ms "
                  f"({100 * b[0] / ms:.1f}%)")
        reset_launch_counts()
        fn = lambda: [adown_front_cuda(x) for x in xs]  # noqa: E731
        fn()
        if launch_counts()["adown"] != len(xs):
            fail(f"adown: {launch_counts()['adown']} launches for {len(xs)} calls")
        ms, windows = median_ms(fn, 10)

        def parent_path():
            for x in xs:
                x1, x2 = F.avg_pool2d(x, 2, 1, 0, False, True).chunk(2, dim=1)
                x1.contiguous(memory_format=torch.channels_last)
                F.max_pool2d_with_indices(x2, 3, 2, 1)

        plain_ms = cuda_ms(lambda: [adown_front_plain(x) for x in xs], 5)
        library_ms = cuda_ms(parent_path, 5)
        counts = {shape: ADOWN_CALLS.count(shape) for shape in inputs}
        device = sum(p["device_ms"] * counts[tuple(p["shape"])] for p in per_shape)
        r = dict(shape=[list(s) for s in ADOWN_CALLS], ms=ms, windows=windows,
                 host_ms=host_ms(fn, 10), device_ms=device, shapes=per_shape,
                 plain_ms=plain_ms, library_ms=library_ms, bound=adown_bound(ADOWN_CALLS))
        print(f"adown, the cell's 8 calls: {ms:.4f} ms (windows {windows}), device "
              f"{device:.4f} ms ({100 * r['bound'][0] / device:.1f}% of the bound), host issue "
              f"{r['host_ms']:.4f} ms; the plain chain {plain_ms:.4f} ms, the parent's path (the "
              f"chain, x1 made dense, the max pool's indices) {library_ms:.4f} ms; bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")
        del inputs, xs
    torch.cuda.empty_cache()
    return r


V9_CELL = "yolov9e.card-b32-2048"  # the YOLOv9-E cell of the benchmark
V9_SEED = 26


def cell_path(dev, cell_name: str, seed: int) -> dict:
    """``run_fused`` of the benchmark cell ``cell_name``'s pipeline as the
    benchmark builds it (``cardbench.program.build`` on
    ``cardbench.weights.make_states``), at the cell's batch, input size and
    frames: one warm-up run, then the launch counts zeroed just before one
    run and read just after."""
    from cardbench import program, spec, traffic
    from cardbench.weights import make_states

    cell = spec.resolve(cell_name)
    cfg, b = cell.config, cell.traffic["batch"]
    h, w = cell.traffic["height"], cell.traffic["width"]
    det, cls = make_states(cfg, seed, dev)
    run_fused = program.build(cfg, det, cls, b, dev)
    frames = traffic.make_frames(seed, 0, b, h, w, dev)
    run_fused(frames)
    torch.cuda.synchronize()
    reset_launch_counts()
    out = run_fused(frames)
    torch.cuda.synchronize()
    counts = launch_counts()
    valid = int(out["valid"].sum())
    print(f"{cell_name} run_fused, B={b} {h}x{w} at {cfg['detector']['input_size']}: "
          f"{valid} valid detections; launches {counts}")
    del run_fused, det, cls, frames, out
    torch.cuda.empty_cache()
    return dict(batch=b, frame=[h, w], valid=valid, launches=counts)


def v9_path(dev) -> dict:
    """:func:`cell_path` of V9_CELL; fails unless the ADown front end ran as
    its kernel 8 times and the fan-in 5 times."""
    r = cell_path(dev, V9_CELL, V9_SEED)
    counts = r["launches"]
    if counts["adown"] != 8 or counts["cbfuse"] != 5:
        fail(f"{V9_CELL} run_fused: adown {counts['adown']} (want 8), cbfuse "
             f"{counts['cbfuse']} (want 5)")
    return r


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
    with pipe.precision(), torch.inference_mode():
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
        # the bf16 sigmoid kernel is the zoo's (EfficientNet-B0's gates), the
        # act kernel's backward mode the training phase's, K1's cluster
        # greedy pass the paths above 960 candidates at a batch of 16 or
        # fewer, area attention YOLO12's, the BatchNorm mode the injected
        # detectors', the max-sigmoid core and the class-head GEMM
        # YOLO-World's, the CBFuse fan-in and the ADown front end YOLOv9-E's:
        # serving runs none of the last ten; its SiLUs all carry their conv's
        # bias (the bias mode), so none runs the plain mode
        if name in ("silu_bf16", "silu_bf16_bwd", "sigmoid_bf16_bwd", "nms_greedy_cluster",
                    "area_attn", "bn_silu_bf16", "bn_bf16", "maxsig", "vocab_gemm", "cbfuse",
                    "adown"):
            if n:
                fail(f"serving launched {name} {n} times")
        elif n < 1 and name != "sigmoid_bf16":
            fail(f"kernel {name} was not launched on the main path")
    for (_, _, _, b, h, w, roi_impl), c in zip(runs, run_counts):
        # bf16: every ConvBN after the stem, and the letterboxed frames' stem
        want = 0 if "float32" in roi_impl else DETECTOR_SILU_CONVS + ((h, w) != (640, 640))
        if c["silu_bias_bf16"] != want:
            fail(f"run_fused b={b} {h}x{w} {roi_impl}: {c['silu_bias_bf16']} bias-mode "
                 f"launches, expected {want}")
    for pipe, _, _, b, h, w, roi_impl in runs:
        # on the card the detector's conv weights are placed channels last
        # once, but those of the blocks that run NCHW; the letterboxed
        # canvases' stem conv, a copy apart from the detector, stays NCHW
        nchw = {m for blk in pipe.det_model.modules() if runs_nchw(blk) for m in blk.modules()}
        for name, m in pipe.det_model.named_modules():
            fmt = torch.contiguous_format if m in nchw else torch.channels_last
            if isinstance(m, torch.nn.Conv2d) and not m.weight.is_contiguous(memory_format=fmt):
                fail(f"run_fused b={b} {h}x{w} {roi_impl}: {name}'s weight is not {fmt}")
        if not pipe._raw_stem.conv.weight.is_contiguous():
            fail(f"run_fused b={b} {h}x{w} {roi_impl}: the letterboxed stem's weight is not NCHW")
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
    ``run_fused`` hands them (through the pipeline's stage methods, under
    its TF32 scope as ``run_fused`` runs them), against
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
    with pipe.precision(), torch.inference_mode():
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
    # the bf16 activation kernel: its BatchNorm mode in every ConvBN of the
    # detectors that keep BatchNorm but the anchor-free YOLOv5n's (torch's
    # F.silu, models/yolov5.py: ATen's BatchNorm), one launch per ConvBN
    # call, with SiLU or alone (YOLOv11n's C2PSA); the plain SiLU in
    # EfficientNet-B0, sigmoid in its gates only, the bias mode in its
    # deploy-form convs
    act_runs = {"yolov11n": ("bn_silu_bf16", "bn_bf16"), "yolov5n": (),
                "yolov5n_legacy": ("silu_bf16", "sigmoid_bf16", "silu_bias_bf16",
                                   "bn_silu_bf16")}
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
        for k in ("silu_bf16", "sigmoid_bf16", "silu_bias_bf16", "bn_silu_bf16", "bn_bf16"):
            if (counts[k] > 0) != (k in act_runs[variant]):
                fail(f"{what}: {k} launched {counts[k]} times")
        # each ConvBN runs once per call; these detectors' act is SiLU or none
        convbns = [m for m in pipe.det_model.modules() if isinstance(m, ConvBN) and m.bn is not None]
        if variant != "yolov5n" and (counts["bn_silu_bf16"], counts["bn_bf16"]) != (
                sum(m.act is act_ops.silu for m in convbns),
                sum(m.act is not act_ops.silu for m in convbns)):
            fail(f"{what}: BatchNorm-mode launches {counts}, ConvBNs {len(convbns)}")
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
    # the detector's own bf16 BatchNorms and SiLUs run the activation
    # kernel; nothing else
    if any(c for key, c in counts.items()
           if key not in ("silu_bf16", "sigmoid_bf16", "bn_silu_bf16", "bn_bf16")):
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
    with K1ByK() as k1:
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
                  launches=counts, k1_launches_by_k={str(k): n for k, n in sorted(k1.by_k.items())},
                  k1_cluster_launches_by_k={str(k): n for k, n in sorted(k1.cluster_by_k.items())},
                  kernel_checks=kernel_checks,
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
    # every prediction of the 640 grid through the device NMS (K1 at 8,400),
    # in bf16 as the pair serves
    large = check_cli_full(dev, weights, img_dir, lbl_dir, root,
                           ["--dtype", "bfloat16", "--max_candidates", str(E2E_CLI_LARGE_K)],
                           f"max_candidates {E2E_CLI_LARGE_K}",
                           {"nms_suppress": 1, "roi_crop_dense": 4, "roi_crop_pyramid": 0,
                            "roi_crop_pyramid_bf16": 0, "stem": 0})
    if not large["k1_cluster_launches_by_k"].get(str(E2E_CLI_LARGE_K)):
        fail(f"e2e CLI at {E2E_CLI_LARGE_K} candidates: K1 by K {large['k1_launches_by_k']}, "
             f"its greedy pass on a cluster {large['k1_cluster_launches_by_k']}")
    result = dict(detector_rel_err=art["detector_rel_err"], small=small, full_dense=dense,
                  full_bf16_pallas=pallas, full_k8400=large, decode_once_s=decode_s,
                  label_detections=n_labels, seconds=time.perf_counter() - t0)
    print(f"e2e CLI phase (artifacts, card vs CPU, three full-width runs): "
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


# --------------------------------------------------------------------- #
# training: the act kernel's backward, the train steps, both CLIs       #
# --------------------------------------------------------------------- #

def check_act_backward(dev) -> dict:
    """The act kernel's backward mode (SiLU and sigmoid) against its plain
    version (``silu_bf16_grad_plain`` / ``sigmoid_bf16_grad_plain``, the
    ops of ``jax.vjp`` each rounded to bf16) on every element of ACT_CASES
    and of ACT_BWD_SHAPE: bit-equal, or the run fails.  The SiLU mode timed
    at ACT_BWD_SHAPE beside the plain passes and torch's one-rounding
    ``silu_backward``; then one EfficientNet-B0 train step at B=8 on the
    card (its squeeze-excite gates), which must launch the sigmoid mode."""
    gen = torch.Generator(device=dev).manual_seed(21)
    differ, n = {}, {}
    for silu in (True, False):
        plain = act_ops.silu_bf16_grad_plain if silu else act_ops.sigmoid_bf16_grad_plain
        for case in (*ACT_CASES, ACT_BWD_SHAPE):
            x = (torch.randn(case, generator=gen, device=dev) * 4).bfloat16()
            g = torch.randn(case, generator=gen, device=dev).bfloat16()
            got = act_bf16_backward_cuda(x, g, silu)
            want = plain(x, g)
            torch.cuda.synchronize()
            bad = int((got.view(torch.int16) != want.view(torch.int16)).sum())
            if bad:
                fail(f"act backward ({'silu' if silu else 'sigmoid'}) {case}: {bad} elements "
                     "differ from the plain version")
            differ[silu], n[silu] = differ.get(silu, 0) + bad, n.get(silu, 0) + got.numel()
    x = (torch.randn(ACT_BWD_SHAPE, generator=gen, device=dev) * 4).bfloat16()
    g = torch.randn(ACT_BWD_SHAPE, generator=gen, device=dev).bfloat16()
    fn = lambda: act_bf16_backward_cuda(x, g, True)  # noqa: E731
    ms, windows = median_ms(fn, 50)
    r = dict(shape=list(ACT_BWD_SHAPE), ms=ms, windows=windows, host_ms=host_ms(fn, 50),
             device_ms=device_ms(fn, 50, "grad_vec_kernel"),
             plain_ms=cuda_ms(lambda: act_ops.silu_bf16_grad_plain(x, g), 10),
             library_ms=cuda_ms(lambda: torch.ops.aten.silu_backward(g, x), 50),
             max_abs_err=0.0, mismatches=differ[True] + differ[False],
             elements=n[True] + n[False],
             # x and g read once, dx written once, 2 bytes each; ~14
             # operations per value (the sigmoid's four steps, its
             # derivative, the product rule) are noise beside the bytes
             bound=bound(6 * x.numel(), 14 * x.numel()))
    del x, g
    print(f"act backward kernel (SiLU) {ACT_BWD_SHAPE}: {ms:.4f} ms (windows {windows}), device "
          f"{r['device_ms']:.4f} ms, host issue {r['host_ms']:.4f} ms; the plain version's "
          f"passes {r['plain_ms']:.4f} ms, torch's silu_backward (one rounding) "
          f"{r['library_ms']:.4f} ms; bound {r['bound'][0]:.4f} ms ({r['bound'][1]}); "
          f"0 of {r['elements']} elements differ (SiLU and sigmoid modes)")
    model = build_classifier("efficientnet", 91)
    state, tx = create_classifier_train_state(model, seed=0, total_steps=10, device=dev)
    batch = {"images": torch.randn(8, 3, 64, 64, generator=gen, device=dev),
             "labels": torch.randint(0, 91, (8,), generator=gen, device=dev)}
    reset_launch_counts()
    _, m = classifier_train_step(state.model, tx, state, batch,
                                 torch.Generator(device=dev).manual_seed(1))
    counts = launch_counts()
    if counts["sigmoid_bf16_bwd"] < 1 or counts["silu_bf16_bwd"] < 1 or not bool(
            torch.isfinite(m["loss"])):
        fail(f"EfficientNet-B0 train step: loss {float(m['loss'])}, launches {counts}")
    r["sigmoid_mode_launches"] = counts["sigmoid_bf16_bwd"]
    print(f"EfficientNet-B0 train step (B=8, bf16): loss {float(m['loss']):.4f}, "
          f"act backward launches silu {counts['silu_bf16_bwd']}, sigmoid "
          f"{counts['sigmoid_bf16_bwd']}")
    return r


def detector_batch(dev, b: int, size: int, gen) -> dict:
    """A device batch of the detector's train step: [0, 1] images and 1 to
    TRAIN_MAX_GT-sized sets of boxes from ``gen``."""
    images = torch.rand(b, 3, size, size, generator=gen, device=dev)
    xy = torch.rand(b, TRAIN_MAX_GT, 2, generator=gen, device=dev) * (size * 0.8)
    wh = 8 + torch.rand(b, TRAIN_MAX_GT, 2, generator=gen, device=dev) * (size * 0.15)
    n = torch.randint(1, 6, (b, 1), generator=gen, device=dev)
    return {"images": images, "gt_boxes": torch.cat([xy, xy + wh], -1),
            "gt_labels": torch.zeros(b, TRAIN_MAX_GT, dtype=torch.int32, device=dev),
            "gt_mask": torch.arange(TRAIN_MAX_GT, device=dev)[None] < n}


def train_step_card_vs_cpu(dev) -> dict:
    """One float32 detector train step (TF32 off) of TRAIN_SMALL at B=2 on
    the card and on the CPU from the same weights and batch: the loss within
    1e-5 relative, every gradient leaf within 1e-3 of its largest element
    (float32 gradient noise: 7e-5 between JAX's float32 and float64 on such a
    net, tests/test_torch_train_detector.py), the parameters after the step
    within 1e-5 (absolute plus relative)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    for where in ("cpu", dev):
        model, state, tx = create_detector_train_state(TRAIN_SMALL, seed=4, dtype=torch.float32,
                                                        total_steps=10, warmup_steps=2,
                                                        device=where)
        batch = {k: v.to(where) for k, v in
                 detector_batch(torch.device("cpu"), 2, TRAIN_SMALL.input_size,
                                torch.Generator().manual_seed(5)).items()}
        anchors, strides = make_anchors(TRAIN_SMALL.input_size, TRAIN_SMALL.strides)
        out = model(batch["images"])
        loss, _ = detection_loss(out, torch.as_tensor(anchors, device=where),
                                 torch.as_tensor(strides, device=where), batch["gt_boxes"],
                                 batch["gt_labels"], batch["gt_mask"])
        grads = torch.autograd.grad(loss, list(model.parameters()))
        model.zero_grad()
        _, m = detector_train_step(model, tx, state, batch, cfg=TRAIN_SMALL)
        runs[str(where)] = (float(loss.detach()), [g.cpu() for g in grads],
                            {k: p.detach().cpu() for k, p in model.named_parameters()},
                            float(m["loss"]))
    (l_cpu, g_cpu, p_cpu, s_cpu), (l_dev, g_dev, p_dev, s_dev) = runs["cpu"], runs[str(dev)]
    loss_rel = abs(l_dev - l_cpu) / abs(l_cpu)
    grad_rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(g_dev, g_cpu))
    param_err = max(float(((p_dev[k] - p_cpu[k]).abs() / (1 + p_cpu[k].abs())).max())
                    for k in p_cpu)
    if not (loss_rel <= 1e-5 and abs(s_dev - s_cpu) <= 1e-5 * abs(s_cpu) and grad_rel <= 1e-3
            and param_err <= 1e-5):
        fail(f"float32 train step card vs CPU: loss {loss_rel}, grads {grad_rel}, "
             f"params {param_err}")
    r = dict(loss=l_dev, loss_rel_err=loss_rel, grad_worst_leaf_rel_err=grad_rel,
             param_max_err=param_err, leaves=len(g_cpu))
    print(f"float32 train step card vs CPU ({TRAIN_SMALL.name} at {TRAIN_SMALL.input_size}, B=2, "
          f"TF32 off): {json.dumps(r)}")
    return r


def time_train_steps(dev) -> dict:
    """The bf16 train steps at full width on device batches (no data
    pipeline): yolo_plus_v2 at 640, B=16, and ShuffleNetV2-91 at 64, B=128;
    CUDA events, the median of WINDOWS windows of TRAIN_TIMED_STEPS steps."""
    gen = torch.Generator(device=dev).manual_seed(22)
    cfg = dataclasses.replace(YOLO_PLUS_V2, input_size=TRAIN_DET_SIZE)
    model, state, tx = create_detector_train_state(cfg, seed=0, total_steps=100, warmup_steps=10,
                                                    device=dev)
    batch = detector_batch(dev, TRAIN_DET_BATCH, TRAIN_DET_SIZE, gen)
    det_ms, det_windows = median_ms(lambda: detector_train_step(model, tx, state, batch, cfg=cfg),
                                    TRAIN_TIMED_STEPS)
    det_host = host_ms(lambda: detector_train_step(model, tx, state, batch, cfg=cfg), 3)
    del model, state, batch
    cls_model = build_classifier("shufflenetv2", 91)
    cstate, ctx = create_classifier_train_state(cls_model, seed=0, total_steps=100, device=dev)
    cbatch = {"images": torch.randn(TRAIN_CLS_BATCH, 3, 64, 64, generator=gen, device=dev),
              "labels": torch.randint(0, 91, (TRAIN_CLS_BATCH,), generator=gen, device=dev)}
    cgen = torch.Generator(device=dev).manual_seed(3)
    cls_ms, cls_windows = median_ms(
        lambda: classifier_train_step(cstate.model, ctx, cstate, cbatch, cgen), TRAIN_TIMED_STEPS)
    r = dict(detector_ms=det_ms, detector_windows=det_windows,
             detector_images_per_s=TRAIN_DET_BATCH / det_ms * 1e3, detector_host_ms=det_host,
             classifier_ms=cls_ms, classifier_windows=cls_windows,
             classifier_images_per_s=TRAIN_CLS_BATCH / cls_ms * 1e3)
    print(f"detector train step (yolo_plus_v2, {TRAIN_DET_SIZE}x{TRAIN_DET_SIZE}, "
          f"B={TRAIN_DET_BATCH}, bf16): {det_ms:.3f} ms (windows {det_windows}), "
          f"{r['detector_images_per_s']:.1f} images/s, host issue {det_host:.3f} ms")
    print(f"classifier train step (ShuffleNetV2-91, 64x64, B={TRAIN_CLS_BATCH}, bf16): "
          f"{cls_ms:.3f} ms (windows {cls_windows}), {r['classifier_images_per_s']:.1f} images/s")
    return r


def write_detection_set(root: str, n: int, rng) -> tuple:
    """``n`` 640x480 JPEG frames with 1 to 3 bright boxes each and their
    YOLO labels (class 0) under ``root``/images and ``root``/labels."""
    from litepi_tpu_torch.tools.dp_cards import write_images

    return write_images(root, n, rng)


def write_crop_set(root: str, rng) -> str:
    """An ImageFolder of TRAIN_CLS_CROPS 64x64 PNG crops for each of 91
    classes, each class its own colour."""
    import cv2

    for c in range(91):
        d = os.path.join(root, f"c{c:02d}")
        os.makedirs(d)
        colour = rng.integers(0, 256, 3)
        for i in range(TRAIN_CLS_CROPS):
            img = np.clip(colour + rng.normal(0, 20, (64, 64, 3)), 0, 255).astype(np.uint8)
            cv2.imwrite(os.path.join(d, f"{i}.png"), img)
    return root


def run_cli(main_fn, argv, what: str) -> str:
    """``main_fn(argv)`` in this process with its standard output captured
    (and printed); fails unless it returns 0."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    text = buf.getvalue()
    print(f"--- {what} ({time.perf_counter() - t0:.1f} s):\n{text.rstrip()}")
    if rc != 0:
        fail(f"{what}: rc {rc}")
    return text


def epoch_losses(text: str, what: str) -> list:
    losses = [float(v) for v in re.findall(r"^epoch \d+/\d+\s+loss (\S+)", text, re.M)]
    if not losses or not all(np.isfinite(losses)):
        fail(f"{what}: epoch losses {losses}")
    return losses


def epoch_seconds(text: str, what: str) -> list:
    """[(epoch seconds, of which validation seconds)] from a training CLI's
    epoch lines."""
    times = [(float(a), float(b)) for a, b in
             re.findall(r"^epoch \d+/\d+ .*\((\S+)s, validation (\S+)s\)$", text, re.M)]
    if not times:
        fail(f"{what}: no epoch times")
    return times


def check_validation_nms(dev, tree, val_dir: str) -> dict:
    """The NMS kernel on validation's own inputs: the validation pipeline
    rebuilt from the run's ``last`` weights (the EMA, as the last epoch
    validated them), the first validation batch letterboxed as the
    evaluator letterboxes it, its K=512 candidates at conf 0.001 through
    the kernel and ``suppress_sorted``: bit-equal."""
    import cv2

    pcfg = PipelineConfig(detector=dataclasses.replace(YOLO_PLUS_V2, input_size=TRAIN_DET_SIZE),
                          nms=NMSConfig(max_candidates=512, max_detections=64, min_area=0.0),
                          input_color="bgr", num_classifier_classes=2,
                          det_input_size=TRAIN_DET_SIZE, batch_size=TRAIN_DET_BATCH)
    clf = build_classifier("shufflenetv2", 2)
    pipe = TwoStagePipeline(pcfg, jax_to_state_dict(tree), seeded_state(clf, 1),
                            dtype=torch.bfloat16, device=dev)
    ev = PipelineEvaluator(pipe)
    paths = sample_images(val_dir)[:TRAIN_DET_BATCH]
    canvases, _ = ev._letterbox_batch([cv2.imread(p) for p in paths])
    with torch.inference_mode():
        boxes, scores, cls = pipe._detect_top(ev._to_unit(canvases), 512)
        valid = scores > 0.001
        keep = nms_suppress_cuda(boxes, cls.to(torch.int32), valid, pcfg.nms.iou_threshold)
        want = suppress_sorted(boxes, valid, cls, pcfg.nms.iou_threshold)
        torch.cuda.synchronize()
    mismatches = int((keep != want).sum())
    if mismatches or not bool(valid.any()):
        fail(f"training validation: {mismatches} NMS keep bits differ, {int(valid.sum())} valid")
    r = dict(nms_valid=int(valid.sum()), nms_kept=int(keep.sum()), nms_mismatches=0,
             shape=list(valid.shape))
    print(f"training validation: on its own inputs (B, K = {r['shape']}) the NMS kernel equals "
          f"suppress_sorted ({r['nms_kept']} of {r['nms_valid']} valid candidates kept)")
    return r


def training_phase(dev, root: str) -> dict:
    """The act kernel's backward, the float32 step card vs CPU, the timed
    steps, then both training CLIs at full width on data written here: the
    detector (yolo_plus_v2, 640, B=16, bf16) for TRAIN_DET_EPOCHS epochs of
    TRAIN_DET_STEPS steps with validation, as a user runs it: its epoch
    and validation seconds, its launch counts zeroed just before and read
    just after (the bf16 SiLU forward and backward and the NMS kernel at
    least once each); under deterministic algorithms the same run again,
    and stopped after one epoch and resumed, the resumed run's last
    epoch's loss equal to the uninterrupted one's; validation's NMS inputs against the
    plain keep mask; and the classifier (ShuffleNetV2-91, 64, B=128) for
    one epoch of TRAIN_CLS_STEPS steps with validation."""
    from litepi_tpu_torch.apps import train_classifier, train_detector
    from litepi_tpu_torch.weights.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    result = {"act_backward": check_act_backward(dev), "card_vs_cpu": train_step_card_vs_cpu(dev),
              "steps": time_train_steps(dev)}
    rng = np.random.default_rng(23)
    train_dir = write_detection_set(os.path.join(root, "det_train"), TRAIN_DET_IMAGES, rng)
    val_dir = write_detection_set(os.path.join(root, "det_val"), TRAIN_DET_VAL_IMAGES, rng)
    common = ["--images", train_dir[0], "--labels", train_dir[1], "--val_images", val_dir[0],
              "--val_labels", val_dir[1], "--imgsz", str(TRAIN_DET_SIZE), "--batch",
              str(TRAIN_DET_BATCH), "--epochs", str(TRAIN_DET_EPOCHS), "--steps_per_epoch",
              str(TRAIN_DET_STEPS), "--max_gt", str(TRAIN_MAX_GT), "--patience", "99",
              "--device", dev.type]
    # the timed run, as a user runs it (cuDNN's own algorithm choice)
    straight = os.path.join(root, "det_straight")
    reset_launch_counts()
    t1 = time.perf_counter()
    text = run_cli(train_detector.main, common + ["--output", straight],
                   "detector CLI, uninterrupted")
    det_seconds = time.perf_counter() - t1
    det_launches = launch_counts()
    losses = epoch_losses(text, "detector CLI")
    det_epochs = epoch_seconds(text, "detector CLI")
    if (det_launches["silu_bf16"] < 1 or det_launches["silu_bf16_bwd"] < 1
            or det_launches["nms_suppress"] < 1 or det_launches["stem"]):
        fail(f"detector CLI: launch counts {det_launches}")
    with open(os.path.join(straight, "results.json")) as f:
        results = json.load(f)
    if sorted(results) != ["best_epoch", "best_map50", "config", "epochs_run", "variant"] \
            or results["epochs_run"] != TRAIN_DET_EPOCHS:
        fail(f"detector CLI: results.json {results}")
    # resume against an uninterrupted run, both under deterministic algorithms
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        text_d = run_cli(train_detector.main,
                         common + ["--output", os.path.join(root, "det_deterministic")],
                         "detector CLI, uninterrupted, deterministic")
        resumed = os.path.join(root, "det_resumed")
        run_cli(train_detector.main, common + ["--output", resumed, "--stop_after", "1"],
                "detector CLI, --stop_after 1, deterministic")
        text_r = run_cli(train_detector.main, common + ["--output", resumed, "--resume"],
                         "detector CLI, --resume, deterministic")
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    det_losses = epoch_losses(text_d, "detector CLI deterministic")
    resumed_losses = epoch_losses(text_r, "detector CLI resumed")
    resume_rel = abs(resumed_losses[-1] - det_losses[-1]) / abs(det_losses[-1])
    if resume_rel > 1e-5:
        fail(f"detector CLI: resumed last loss {resumed_losses[-1]} != {det_losses[-1]}")
    validation = check_validation_nms(dev, load_checkpoint(os.path.join(straight, "last")),
                                      val_dir[0])
    crops = write_crop_set(os.path.join(root, "crops"), rng)
    reset_launch_counts()
    t1 = time.perf_counter()
    ctext = run_cli(train_classifier.main,
                    ["--data", crops, "--val_data", crops, "--img_size", "64", "--batch",
                     str(TRAIN_CLS_BATCH), "--epochs", "1", "--steps_per_epoch",
                     str(TRAIN_CLS_STEPS), "--output", os.path.join(root, "cls"),
                     "--device", dev.type], "classifier CLI")
    cls_seconds = time.perf_counter() - t1
    cls_launches = launch_counts()
    cls_losses = epoch_losses(ctext, "classifier CLI")
    cls_epochs = epoch_seconds(ctext, "classifier CLI")
    result.update(
        detector_cli=dict(seconds=det_seconds, epoch_losses=losses, results=results,
                          launches=det_launches, epoch_seconds=[a for a, _ in det_epochs],
                          validation_seconds=[b for _, b in det_epochs],
                          deterministic_losses=det_losses, resumed_losses=resumed_losses,
                          resume_rel_diff=resume_rel),
        validation_nms=validation,
        classifier_cli=dict(seconds=cls_seconds, epoch_losses=cls_losses,
                            launches=cls_launches, epoch_seconds=[a for a, _ in cls_epochs],
                            validation_seconds=[b for _, b in cls_epochs]),
        train_launches={k: det_launches[k] + cls_launches[k] for k in det_launches},
        seconds=time.perf_counter() - t0)
    print(f"detector CLI ({TRAIN_DET_STEPS} steps of B={TRAIN_DET_BATCH} at {TRAIN_DET_SIZE} per "
          f"epoch, not deterministic): epochs {[a for a, _ in det_epochs]} s, of which "
          f"validation {[b for _, b in det_epochs]} s; classifier CLI ({TRAIN_CLS_STEPS} steps of "
          f"B={TRAIN_CLS_BATCH}): epoch {[a for a, _ in cls_epochs]} s, of which validation "
          f"{[b for _, b in cls_epochs]} s")
    print(f"training phase (act backward, card vs CPU step, timed steps, detector CLI x4, "
          f"classifier CLI): {result['seconds']:.1f} s; resumed last loss "
          f"{resumed_losses[-1]} vs deterministic uninterrupted {det_losses[-1]} "
          f"(rel diff {resume_rel:.3g})")
    return result


# --------------------------------------------------------------------- #
# the baselines: Faster R-CNN, SSD300, their CLI, both benches          #
# --------------------------------------------------------------------- #

class NmsRecorder:
    """Stands in for ``suppress`` in a module: records each call's inputs
    (cloned) and calls the real one."""

    def __init__(self, module):
        self.module, self.real, self.calls = module, module.suppress, []

    def __enter__(self):
        def record(boxes, valid, cls, thr):
            self.calls.append((boxes.clone(), valid.clone(), cls.clone(), thr))
            return self.real(boxes, valid, cls, thr)

        self.module.suppress = record
        return self

    def __exit__(self, *exc):
        self.module.suppress = self.real


class ProposalChoices:
    """Stands in for ``topk_stable`` and ``suppress`` in
    ``models.faster_rcnn``.  Without ``given`` it records a forward's
    choices (its two top-k picks and its RPN keep mask, in call order);
    with ``given`` (another forward's record) the forward computes its own
    choices, keeps them in ``chosen`` and goes on with the given ones, its
    scores gathered at the given picks, so that two runs whose objectness
    differs by rounding noise are compared on the same proposals.  Each
    NMS call's inputs are kept in ``nms_calls`` (``nms_keep_check``)."""

    def __init__(self, given=None):
        self.given, self.chosen, self.ranked, self.nms_calls = given, [], [], []

    def _choose(self, own):
        self.chosen.append(own.detach().clone())
        if self.given is None:
            return own
        return self.given[len(self.chosen) - 1].to(own.device)

    def __enter__(self):
        from litepi_tpu_torch.models import faster_rcnn as frcnn_mod

        self.module, self.real = frcnn_mod, (frcnn_mod.topk_stable, frcnn_mod.suppress)
        real_topk, real_suppress = self.real

        def topk(x, k):
            values, idx = real_topk(x, k)
            picks = self._choose(idx)
            if picks is idx:
                return values, idx
            taken = torch.gather(x, 1, picks)
            self.ranked.append((taken.detach().cpu(), values.detach().cpu()))
            return taken, picks

        def supp(boxes, valid, cls, thr):
            self.nms_calls.append((boxes.clone(), valid.clone(), cls.clone(), thr))
            return self._choose(real_suppress(boxes, valid, cls, thr))

        frcnn_mod.topk_stable, frcnn_mod.suppress = topk, supp
        return self

    def __exit__(self, *exc):
        self.module.topk_stable, self.module.suppress = self.real

    def check_near_ties(self, eps: float, what: str) -> dict:
        """After a replay: every given top-k pick must be one that an exact
        top-k of scores ``eps`` away from this run's could make.  At each
        rank the score this run has at the given pick lies within ``2 *
        eps`` of this run's own top-k score at that rank (the sorted scores
        of two runs ``eps`` apart are ``eps`` apart rank by rank), -inf
        exactly where its own is; ``eps`` is the largest difference of the
        two runs' objectness.  A wrong pick on the recording side fails.
        Returns the worst gap and how many choices differ."""
        worst = 0.0
        for taken, own in self.ranked:
            finite = torch.isfinite(own)
            if not torch.equal(finite, torch.isfinite(taken)):
                fail(f"{what}: the given top-k picks {int(torch.isfinite(taken).sum())} "
                     f"finite scores where the own picks {int(finite.sum())}")
            if bool(finite.any()):
                gap = (taken[finite].double() - own[finite].double()).abs().max()
                worst = max(worst, float(gap))
        differ = {name: int((own.cpu() != given.cpu()).sum()) for name, own, given in
                  zip(("topk", "keep", "selected"), self.chosen, self.given)}
        r = dict(worst_rank_gap=worst, bound=2 * eps, own_choices_differ=differ)
        if worst > 2 * eps:
            fail(f"{what}: a given top-k pick is no near-tie {r}")
        return r


def nms_keep_check(call, what: str) -> dict:
    """The NMS kernel against ``suppress_sorted`` on one recorded call's
    inputs: bit-equal or the run fails."""
    boxes, valid, cls, thr = call
    keep = nms_suppress_cuda(boxes, cls.to(torch.int32), valid, thr)
    want = suppress_sorted(boxes, valid, cls, thr)
    torch.cuda.synchronize()
    bad = int((keep != want).sum())
    if bad or not bool(valid.any()):
        fail(f"{what}: {bad} NMS keep bits differ from suppress_sorted, {int(valid.sum())} valid")
    r = dict(shape=list(valid.shape), valid=int(valid.sum()), kept=int(keep.sum()),
             classes=int(cls.unique().numel()), mismatches=0)
    print(f"{what}: the NMS kernel equals suppress_sorted on its own inputs {r}")
    return r


def baseline_card_vs_cpu(dev) -> dict:
    """Faster R-CNN's float32 forward at 640, B=2 (eval mode, TF32 off) on
    the card vs the CPU, the CPU on the card's proposal choices (top-k,
    NMS keep mask, survivors: :class:`ProposalChoices`): RPN outputs,
    proposals, scores and box-head outputs within BASE_REL_TOL of each
    output's scale; the card's top-k picks near-ties of the CPU's own
    (``ProposalChoices.check_near_ties``) and its RPN keep mask bit-equal
    to ``suppress_sorted`` on its own inputs.  Then one train step of each
    baseline (Faster R-CNN at BASE_STEP_SIZE on the card's choices, held
    the same way; SSD300 at 300; B=2, the sampling draws given) card vs
    CPU at the detector step's tolerances: loss 1e-5 relative, every
    gradient leaf within 1e-3 of its largest element, the parameters after
    the step within 1e-5.  The step runs in float64: in float32 each
    baseline's gradient is in part rounding noise (on the CPU the port's
    own float32 gradient stands up to 68% of a leaf's scale from its
    float64 gradient for Faster R-CNN at 640, B=2, 0.45% for SSD300, and
    the float32 Faster R-CNN step's leaves stood 24% apart card vs CPU),
    which no tolerance of 1e-3 can hold; the model's float32 casts (the
    RPN's and the box head's outputs) stay."""
    from litepi_tpu_torch.train.baselines import baseline_loss, create_baseline_train_state

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = torch.device("cpu")
    result = {}
    outs = {}
    x = torch.rand(BASE_CHECK_BATCH, 3, 640, 640, generator=torch.Generator().manual_seed(9))
    card = ProposalChoices()
    for key, where, choices in (("card", dev, card), ("cpu", cpu, ProposalChoices(card.chosen))):
        state, _ = create_baseline_train_state("faster_rcnn", 1, 640, seed=8,
                                               dtype=torch.float32, device=where)
        with torch.no_grad(), choices:
            outs[key] = {k: v.cpu() for k, v in state.model.eval()(x.to(where)).items()}
    want, got = outs["cpu"], outs["card"]
    errs = {}
    for k in ("rpn_obj", "rpn_deltas", "proposals", "proposal_scores", "roi_cls", "roi_reg"):
        errs[k] = float((got[k] - want[k]).abs().max() / want[k].abs().max())
        if errs[k] > BASE_REL_TOL:
            fail(f"faster_rcnn forward card vs CPU: {k} {errs[k]}")
    eps = float((got["rpn_obj"].double() - want["rpn_obj"].double()).abs().max())
    ties = choices.check_near_ties(eps, "faster_rcnn forward card vs CPU")
    rpn_nms = nms_keep_check(card.nms_calls[0], "faster_rcnn float32 forward RPN NMS")
    result["frcnn_forward"] = dict(batch=BASE_CHECK_BATCH, size=640, rel_err=errs,
                                   valid=int(want["proposal_valid"].sum()), choices=ties,
                                   rpn_nms=rpn_nms)
    print(f"faster_rcnn float32 forward 640x640 B={BASE_CHECK_BATCH} card vs CPU on the card's "
          f"proposal choices: {errs}; the card's picks are near-ties of the CPU's {ties}")
    result["frcnn_forward_k2000"] = baseline_rpn_k2000(dev, x)

    for arch, size in (("faster_rcnn", BASE_STEP_SIZE), ("ssd300", 300)):
        runs = {}
        batch_cpu = detector_batch(cpu, BASE_CHECK_BATCH, size, torch.Generator().manual_seed(10))
        batch_cpu = {k: v.double() if v.is_floating_point() else v for k, v in batch_cpu.items()}
        # the sampling draws (B, A) twice and (B, R) twice, given to both sides
        n_anchors = sum(3 * (size // st) ** 2 for st in (4, 8, 16, 32, 64))
        dgen = torch.Generator().manual_seed(12)
        draws = [torch.rand(shape, generator=dgen, dtype=torch.float64) for shape in
                 ((BASE_CHECK_BATCH, n_anchors),) * 2 + ((BASE_CHECK_BATCH, 256),) * 2]
        card = ProposalChoices()
        for key, where, choices in (("card", dev, card),
                                    ("cpu", cpu, ProposalChoices(card.chosen))):
            state, tx = create_baseline_train_state(arch, 1, size, seed=11, lr=1e-4, epochs=30,
                                                    steps_per_epoch=10, dtype=torch.float64,
                                                    device=where)
            state.model.double()
            batch = {k: v.to(where) for k, v in batch_cpu.items()}
            d = [t.to(where) for t in draws] if arch == "faster_rcnn" else None
            with choices:
                loss, _, out = baseline_loss(state, batch, d)
            params = list(state.model.parameters())
            grads = torch.autograd.grad(loss, params)
            tx.update_(params, grads, state.opt_state, 0)
            runs[key] = (float(loss.detach()), [g.cpu() for g in grads],
                         {k: p.detach().cpu() for k, p in state.model.named_parameters()},
                         out.get("rpn_obj"))
        (l_cpu, g_cpu, p_cpu, obj_cpu), (l_dev, g_dev, p_dev, obj_dev) = runs["cpu"], runs["card"]
        loss_rel = abs(l_dev - l_cpu) / abs(l_cpu)
        grad_rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                       for a, b in zip(g_dev, g_cpu))
        param_err = max(float(((p_dev[k] - p_cpu[k]).abs() / (1 + p_cpu[k].abs())).max())
                        for k in p_cpu)
        r = dict(loss=l_dev, loss_rel_err=loss_rel, grad_worst_leaf_rel_err=grad_rel,
                 param_max_err=param_err, leaves=len(g_cpu))
        if arch == "faster_rcnn":
            eps = float((obj_dev.detach().cpu().double() - obj_cpu.detach().double()).abs().max())
            r["choices"] = choices.check_near_ties(eps, f"{arch} float64 train step card vs CPU")
            r["rpn_nms"] = nms_keep_check(card.nms_calls[0], f"{arch} float64 train step RPN NMS")
        print(f"{arch} float64 train step card vs CPU ({size}x{size}, B={BASE_CHECK_BATCH}): "
              f"{json.dumps(r)}")
        if not (loss_rel <= 1e-5 and grad_rel <= 1e-3 and param_err <= 1e-5):
            fail(f"{arch} float64 train step card vs CPU: {r}")
        result[f"{arch}_step"] = r
    return result


def baseline_rpn_k2000(dev, x) -> dict:
    """Faster R-CNN's float32 forward at 640 with ``pre_nms_topk``
    BASE_LARGE_PRE_NMS (TF32 off, B=2, ``x``): the card's RPN keep mask
    (K1 at K = 2,000) bit-equal to ``suppress_sorted`` on its own inputs and
    to the CPU's keep mask on the card's top-k picks
    (:class:`ProposalChoices`), each pick a near-tie of the CPU's own."""
    from litepi_tpu_torch.train.baselines import create_baseline_train_state

    card = ProposalChoices()
    cpu_choices = ProposalChoices(card.chosen)
    outs = {}
    for key, where, choices in (("card", dev, card), ("cpu", torch.device("cpu"), cpu_choices)):
        state, _ = create_baseline_train_state("faster_rcnn", 1, 640, seed=8,
                                               pre_nms_topk=BASE_LARGE_PRE_NMS,
                                               dtype=torch.float32, device=where)
        with torch.no_grad(), choices:
            outs[key] = {k: v.cpu() for k, v in state.model.eval()(x.to(where)).items()}
    boxes, valid, _, _ = card.nms_calls[0]
    if tuple(valid.shape) != (BASE_CHECK_BATCH, BASE_LARGE_PRE_NMS):
        fail(f"faster_rcnn RPN at pre_nms_topk {BASE_LARGE_PRE_NMS}: NMS shape {valid.shape}")
    eps = float((outs["card"]["rpn_obj"].double() - outs["cpu"]["rpn_obj"].double()).abs().max())
    ties = cpu_choices.check_near_ties(eps, "faster_rcnn forward at K=2,000 card vs CPU")
    keep_differ = int((card.chosen[1].cpu() != cpu_choices.chosen[1].cpu()).sum())
    if keep_differ:
        fail(f"faster_rcnn RPN at K={BASE_LARGE_PRE_NMS}: {keep_differ} keep bits of the card "
             "differ from the CPU's on the card's picks")
    r = dict(rpn_nms=nms_keep_check(card.nms_calls[0], "faster_rcnn RPN NMS at K=2,000"),
             choices=ties, keep_bits_differ_cpu=keep_differ)
    print(f"faster_rcnn float32 forward at pre_nms_topk {BASE_LARGE_PRE_NMS}: the card's RPN "
          f"keep mask equals the CPU's on the card's picks; {json.dumps(r)}")
    return r


def time_baseline_steps(dev) -> dict:
    """Each baseline's bf16 train step at the recipe's full width on device
    batches (B=8; Faster R-CNN at 640 with 1,024 / 256 proposals, SSD300 at
    300): CUDA events, the median of WINDOWS windows of BASE_TIMED_STEPS
    steps, and the host's time to issue one step."""
    from litepi_tpu_torch.train.baselines import baseline_train_step, create_baseline_train_state

    gen = torch.Generator(device=dev).manual_seed(13)
    r = {}
    for arch, size in (("faster_rcnn", 640), ("ssd300", 300)):
        torch.cuda.reset_peak_memory_stats()
        state, tx = create_baseline_train_state(arch, 1, size, seed=0, lr=1e-4, epochs=30,
                                                steps_per_epoch=100, device=dev)
        batch = detector_batch(dev, BASE_BATCH, size, gen)
        draws = torch.Generator(device=dev).manual_seed(14)
        step = lambda: baseline_train_step(state, tx, batch, draws)  # noqa: E731
        ms, windows = median_ms(step, BASE_TIMED_STEPS, 2)
        host = host_ms(step, 2)
        r[arch] = dict(size=size, batch=BASE_BATCH, ms=ms, windows=windows, host_ms=host,
                       images_per_s=BASE_BATCH / ms * 1e3,
                       peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        print(f"{arch} bf16 train step ({size}x{size}, B={BASE_BATCH}): {ms:.3f} ms "
              f"(windows {windows}), host issue {host:.3f} ms, "
              f"{r[arch]['images_per_s']:.1f} images/s")
        del state, tx, batch
    return r


def baseline_inference(dev) -> dict:
    """Faster R-CNN (640) and SSD300 at B=8 in bf16 through
    ``detector_bench.make_harness``: ``infer`` + ``post`` issued under
    ``set_sync_debug_mode("error")``; the NMS kernel on its own inputs of
    that run (the RPN's (8, 1,024) candidates of 1 class, the final
    class-aware NMS at K=256 of each model) bit-equal to
    ``suppress_sorted``; the RPN's call timed (``ms``, ``device_ms``,
    ``host_ms``) beside its bound and the plain version."""
    from litepi_tpu_torch.bench.detector_bench import make_harness
    from litepi_tpu_torch.models import faster_rcnn as frcnn_mod

    gen = torch.Generator(device=dev).manual_seed(15)
    result = {}
    for variant in ("faster_rcnn", "ssd300"):
        h = make_harness(variant, 640, "bfloat16", seed=0, num_classes=1, conf=0.05, device=dev)
        frames = torch.randint(0, 256, (BASE_BATCH, 640, 640, 3), generator=gen, device=dev,
                               dtype=torch.uint8)
        with torch.inference_mode():
            x = h.pre(frames)
            h.post(h.infer(x))  # warm-up (cuDNN's algorithm choice)
            torch.cuda.synchronize()
            with NmsRecorder(frcnn_mod) as rpn, NmsRecorder(nms_ops) as final:
                out, counts = issue_sync_free(lambda: h.post(h.infer(x)), f"{variant} infer + post")
        if counts["nms_suppress"] < 1 or counts["stem"]:
            fail(f"{variant} inference: launch counts {counts}")
        b, s, c, v = out
        if not bool(torch.isfinite(b).all()) or tuple(b.shape) != (BASE_BATCH, 64, 4):
            fail(f"{variant} inference: boxes not finite of shape ({BASE_BATCH}, 64, 4)")
        r = dict(launches=counts, detections=int(v.sum()),
                 final_nms=nms_keep_check(final.calls[0], f"{variant} final NMS"))
        if variant == "faster_rcnn":
            call = rpn.calls[0]
            r["rpn_nms"] = nms_keep_check(call, "faster_rcnn RPN NMS")
            boxes, valid, cls, thr = call
            cls32 = cls.to(torch.int32)
            fn = lambda: nms_suppress_cuda(boxes, cls32, valid, thr)  # noqa: E731
            plain = lambda: suppress_sorted(boxes, valid, cls, thr)  # noqa: E731
            r["rpn_nms_timing"] = dict(
                ms=median_ms(fn, 100)[0], device_ms=device_ms(fn, 100, "nms_"),
                host_ms=host_ms(fn, 100), plain_ms=median_ms(plain, 3, 1)[0],
                bound=nms_bound(boxes, cls32, valid), library_ms=None)
            print(f"faster_rcnn RPN NMS (B, K) = {list(valid.shape)}: "
                  f"{json.dumps(r['rpn_nms_timing'])}")
        print(f"{variant} bf16 inference B={BASE_BATCH}: infer + post issued without a host "
              f"synchronisation; {r['detections']} detections; launch counts {counts}")
        result[variant] = r
    return result


def baseline_windowed(dev) -> dict:
    """``roi_impl="windowed"``'s crop card vs CPU on B=8 1080x1920 frames
    (boxes from 8 to 400 pixels: the window's own taps and the pyramid
    levels) in float32 and with bf16 rounding, within ROI_TOL; then on
    128x128 frames, no larger than the window, where it is the dense crop:
    the ROI kernel launched once."""
    from litepi_tpu_torch.ops.roi import crop_and_resize_windowed

    gen = torch.Generator().manual_seed(16)
    frames = torch.randint(0, 256, (8, 1080, 1920, 3), generator=gen, dtype=torch.uint8)
    xy = torch.rand(8, 8, 2, generator=gen) * torch.tensor([1400.0, 600.0])
    side = 8 + torch.rand(8, 8, 2, generator=gen) * 392
    boxes = torch.cat([xy, xy + side], -1)
    valid = torch.rand(8, 8, generator=gen) > 0.1
    r = {}
    for dtype in (torch.float32, torch.bfloat16):
        want = crop_and_resize_windowed(frames, boxes, valid, 64, dtype)
        got = crop_and_resize_windowed(frames.to(dev), boxes.to(dev), valid.to(dev), 64,
                                       dtype).cpu()
        err = float((got - want).abs().max())
        if err > ROI_TOL:
            fail(f"windowed crop ({dtype}) card vs CPU: max err {err}")
        r[str(dtype).split(".")[-1]] = err
    small = frames[:, :128, :128].contiguous().to(dev)
    reset_launch_counts()
    crop_and_resize_windowed(small, (boxes % 120).to(dev), valid.to(dev), 64)
    n = launch_counts()["roi_crop_dense"]
    torch.cuda.synchronize()
    if n != 1:
        fail(f"windowed crop on 128x128 frames launched the ROI kernel {n} times, not once")
    r["small_frame_roi_launches"] = n
    print(f"windowed crop card vs CPU (B=8, 1080x1920, D=8): max err {r}")
    return r


def bench_rows(text: str) -> list:
    rows = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
    if not rows:
        fail("detector bench printed no row")
    return rows


def baselines_phase(dev, root: str, smi: str) -> dict:
    """The baselines at full width (see the module docstring, step 13)."""
    t0 = time.perf_counter()
    result = {"card_vs_cpu": baseline_card_vs_cpu(dev), "windowed": baseline_windowed(dev)}
    with fresh_tf32():  # the timed steps, CLIs and benches as a user's process runs them
        result.update(steps=time_baseline_steps(dev), inference=baseline_inference(dev))
        baselines_as_users_run_them(dev, root, smi, result)
    print(f"baselines phase (card vs CPU, timed steps, inference, windowed crop, both CLIs, "
          f"both checkpoint benches, the fair benchmark at B={BASE_BENCH_BATCHES}): "
          f"{time.perf_counter() - t0:.1f} s; launches {result['launches']}")
    result["seconds"] = time.perf_counter() - t0
    return result


def baselines_as_users_run_them(dev, root: str, smi: str, result: dict) -> None:
    """Both training CLIs, both checkpoint benches and the fair benchmark,
    their launch counts zeroed before each and summed into ``result``."""
    from litepi_tpu_torch.apps import train_baselines
    from litepi_tpu_torch.bench import detector_bench

    rng = np.random.default_rng(24)
    train_dir = write_detection_set(os.path.join(root, "base_train"), BASE_IMAGES, rng)
    val_dir = write_detection_set(os.path.join(root, "base_val"), BASE_VAL_IMAGES, rng)
    launches = {k: 0 for k in launch_counts()}
    # K1's launches by K (the RPN's 1,024 or 2,000, the final NMS's 256, ...)
    k1 = K1ByK()
    k2000 = k2000_cluster = {}

    def counted(fn):
        reset_launch_counts()
        with k1:
            out = fn()
        for k, v in launch_counts().items():
            launches[k] += v
        return out

    clis, benches = {}, {}
    # the recipes, then Faster R-CNN at torchvision's training budget of
    # 2,000 proposals before the RPN's NMS (K1 above 1,024)
    for name, arch, extra in (("faster_rcnn", "faster_rcnn", []), ("ssd300", "ssd300", []),
                              ("faster_rcnn_k2000", "faster_rcnn",
                               ["--pre_nms_topk", str(BASE_LARGE_PRE_NMS)])):
        out_dir = os.path.join(root, f"base_{name}")
        argv = ["--arch", arch, "--images", train_dir[0], "--labels", train_dir[1],
                "--val_images", val_dir[0], "--val_labels", val_dir[1], "--batch",
                str(BASE_BATCH), "--epochs", str(BASE_EPOCHS), "--steps_per_epoch",
                str(BASE_STEPS), "--max_gt", str(TRAIN_MAX_GT), "--patience", "99",
                "--output", out_dir, "--device", dev.type, *extra]
        t1 = time.perf_counter()
        before, before_cluster = dict(k1.by_k), dict(k1.cluster_by_k)
        text = counted(lambda: run_cli(train_baselines.main, argv, f"train_baselines {name}"))
        seconds = time.perf_counter() - t1
        with open(os.path.join(out_dir, "results.json")) as f:
            res = json.load(f)
        if sorted(res) != ["arch", "best_epoch", "best_score", "epochs_run"] \
                or res["epochs_run"] != BASE_EPOCHS:
            fail(f"train_baselines {name}: results.json {res}")
        epochs = epoch_seconds(text, f"train_baselines {name}")
        clis[name] = dict(seconds=seconds, epoch_losses=epoch_losses(text, name), results=res,
                          epoch_seconds=[a for a, _ in epochs],
                          validation_seconds=[b for _, b in epochs],
                          k1_launches_by_k={str(k): n - before.get(k, 0)
                                            for k, n in sorted(k1.by_k.items())
                                            if n - before.get(k, 0)},
                          k1_cluster_launches_by_k={
                              str(k): n - before_cluster.get(k, 0)
                              for k, n in sorted(k1.cluster_by_k.items())
                              if n - before_cluster.get(k, 0)})
        if extra:
            k2000 = clis[name]["k1_launches_by_k"]
            k2000_cluster = clis[name]["k1_cluster_launches_by_k"]
            if not k2000_cluster.get(str(BASE_LARGE_PRE_NMS)):
                fail(f"train_baselines {name}: K1's cluster greedy pass never ran at "
                     f"K={BASE_LARGE_PRE_NMS}: K1 by K {k2000}, on a cluster {k2000_cluster}")
            continue
        bench_argv = ["--variants", arch, "--checkpoint", os.path.join(out_dir, "last"),
                      "--images", val_dir[0], "--labels", val_dir[1], "--device", dev.type]
        row = bench_rows(counted(lambda: run_cli(detector_bench.main, bench_argv,
                                                 f"detector_bench --checkpoint {arch}")))[0]
        for key in ("mAP50", "mAP50_95", "precision", "recall", "fps"):
            if not np.isfinite(row[key]):
                fail(f"detector_bench {arch}: {key} {row[key]}")
        benches[arch] = row
        print(json.dumps({"baseline_checkpoint_bench": row, "card": smi}))
    fair = []
    for b in BASE_BENCH_BATCHES:
        rows = counted(lambda: detector_bench.run_fair_benchmark(
            detector_bench.ALL_VARIANTS, batch=b, device=dev))
        for row in rows:
            print(json.dumps({"fair_benchmark": row, "card": smi}))
        fair += rows
    if launches["nms_suppress"] < 1 or launches["stem"] or not k1.by_k.get(1024) \
            or sum(k1.by_k.values()) != launches["nms_suppress"]:
        fail(f"baselines phase: launch counts {launches}, K1 by K {k1.by_k}")
    result.update(cli=clis, checkpoint_bench=benches, fair_benchmark=fair, launches=launches,
                  k1_launches_by_k={str(k): n for k, n in sorted(k1.by_k.items())},
                  k1_cluster_launches_by_k={str(k): n for k, n in sorted(k1.cluster_by_k.items())},
                  k2000_cli_launches_by_k=k2000, k2000_cli_cluster_launches_by_k=k2000_cluster)


# --------------------------------------------------------------------- #
# the TF32 scope of a float32 pipeline                                  #
# --------------------------------------------------------------------- #

def tf32_flags() -> tuple:
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def set_tf32(value: bool) -> None:
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = value


def check_tf32_scope(dev) -> dict:
    """A float32 pipeline on the card leaves the caller's TF32 flags as it
    found them, on and off, around its construction and each entry point
    (``run_fused``, ``detect``, ``detect_candidates``, ``classify``), while
    its detector computes with TF32 off; then, with the caller's TF32 on,
    the small float32 pipeline still equals the CPU's
    (:func:`check_small_pipeline`)."""
    saved = tf32_flags()
    seen = []
    frames = torch.from_numpy(peaked_frames(11)).to(dev)
    s = SMALL.det_input_size
    canvas = torch.rand((2, s, s, 3), generator=torch.Generator(device=dev).manual_seed(41),
                        device=dev)
    crops = torch.rand((4, 64, 64, 3), generator=torch.Generator(device=dev).manual_seed(42),
                       device=dev)
    try:
        for caller in (True, False):
            set_tf32(caller)
            pipe = TwoStagePipeline.initialize(SMALL, seed=3, device=dev)
            hook = pipe.det_model.register_forward_pre_hook(lambda *_: seen.append(tf32_flags()))
            after = [tf32_flags()]
            for call in (lambda: pipe.run_fused(frames), lambda: pipe.detect(canvas),
                         lambda: pipe.detect_candidates(canvas), lambda: pipe.classify(crops)):
                call()
                after.append(tf32_flags())
            hook.remove()
            if set(after) != {(caller, caller)} or set(seen) != {(False, False)}:
                fail(f"TF32 scope: caller's flags {caller}, after each call {after}, inside "
                     f"{set(seen)}")
        set_tf32(True)
        check_small_pipeline(dev, *SMALL_SCENES[0], what="small pipeline, caller's TF32 on")
        if tf32_flags() != (True, True):
            fail("TF32 scope: the parity check changed the caller's flags")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    print("TF32 scope: a float32 pipeline gives the caller's flags back (on and off) and runs "
          f"its detector with TF32 off ({len(seen)} forwards seen)")
    return dict(forwards_seen=len(seen), caller_flags_kept=True)


# --------------------------------------------------------------------- #
# the stream app (the reference's deployed app)                          #
# --------------------------------------------------------------------- #

def stream_conf(cpu: dict, card: dict) -> tuple:
    """(conf, half-gap, noise): the middle of the widest gap of the CPU's
    detection scores ({mode: frames x slots, descending}) with at most
    STREAM_MAX_ABOVE scores over it in each frame and at least
    STREAM_MIN_ABOVE in each mode's frames together, and the largest
    card-vs-CPU difference of the top STREAM_MAX_ABOVE + 1 scores of a
    frame, the ranks between which it falls
    (tests/test_torch_bf16_parity.py's rule).  The half-gap, and the
    spacing of the scores over it, must exceed twice that noise, so that
    both runs keep the same candidates in the same order."""
    top = STREAM_MAX_ABOVE + 1
    noise = max(float(np.abs(cpu[m][:, :top] - card[m][:, :top]).max()) for m in cpu)
    every = np.concatenate(list(cpu.values()))
    flat = np.unique(every[:, :top].ravel())[::-1]
    flat = flat[flat > 0]
    best = None
    for a, b in zip(flat[:-1], flat[1:]):
        conf = (float(a) + float(b)) / 2
        above = [np.sort(x[x > conf]) for x in every]
        if (all(int((s > conf).sum()) >= STREAM_MIN_ABOVE for s in cpu.values())
                and all(len(x) <= STREAM_MAX_ABOVE for x in above)
                and all((np.diff(x) > 2 * noise).all() for x in above)
                and (best is None or a - b > 2 * best[1])):
            best = (conf, (float(a) - float(b)) / 2)
    if best is None or not best[1] > 2 * noise:
        tops = {m: np.round(v[:, :4], 4).tolist() for m, v in cpu.items()}
        fail(f"stream app: no conf threshold in a gap wider than twice the card-vs-CPU "
             f"noise {noise} ({best}); top scores {tops}")
    return best[0], best[1], noise


def stream_rows(path: str) -> list:
    import csv

    with open(path) as f:
        return list(csv.reader(f))


def compare_stream_rows(got: list, want: list, bounds: dict, what: str) -> int:
    """The app's CSV rows card vs CPU: header, frame, class name and the
    placeholder rows equal; corners and confidences within ``bounds``.
    Returns the number of detection rows."""
    from litepi_tpu_torch.apps.stream import CSV_HEADER

    if got[0] != CSV_HEADER or want[0] != CSV_HEADER or len(got) != len(want):
        fail(f"{what}: {len(got)} CSV rows on the card, {len(want)} on the CPU")
    n = 0
    for g, w in zip(got[1:], want[1:]):
        if g[0] != w[0] or g[6] != w[6] or (w[1] == "") != (g[1] == ""):
            fail(f"{what}: row {g} on the card, {w} on the CPU")
        if w[1] == "":
            continue
        n += 1
        for i, key in ((1, "boxes"), (2, "boxes"), (3, "boxes"), (4, "boxes"),
                       (5, "det_scores"), (7, "cls_scores")):
            if not abs(float(g[i]) - float(w[i])) <= bounds[key]:
                fail(f"{what}: {CSV_HEADER[i]} {g[i]} on the card, {w[i]} on the CPU "
                     f"(bound {bounds[key]})")
    return n


def stream_phase(dev, root: str, art: dict, img_dir: str) -> dict:
    """The stream app (``apps/stream.py::main``) at its defaults (bf16, 640,
    256 candidates, 16 detections, batch 8) on the e2e CLI phase's
    artifacts (the ``.pt`` detector, the ShuffleNetV2-91 ``.pth`` with its
    Dense x300) and frames (``img_dir``, 2048x2048 JPEGs, on which that
    detector finds boxes over the min-area floor): video mode on an mp4
    this phase writes of STREAM_VIDEO_FRAMES of them and folder mode on
    STREAM_FOLDER_FRAMES, on
    the card and on the CPU, each card run with its launch counts zeroed
    just before and read just after (K1 and K2 dense at least once, K3 and
    the pyramid crop never).  ``--conf`` sits in a gap of the CPU's
    detection scores wider than twice the card-vs-CPU score difference
    (:func:`stream_conf`);
    the CSV rows card vs CPU: frames, class names and placeholder rows
    equal, corners and confidences within the bf16 bound of
    tests/test_torch_bf16_parity.py's rule taken on both sides: each side's
    bf16 drift from its float32 program, measured on the app's own batches,
    plus STREAM_F32_TOL, the float32 tolerance card vs CPU (their sum
    bounds the two bf16 programs' difference by the triangle inequality).
    The two float32 programs, on the same batches, must lie within
    STREAM_F32_TOL of each other, so that a fault of the card's that both
    dtypes share fails there and cannot widen the bound.  Then K1 and K2
    against their plain versions on the video's first batch
    (:func:`check_path_kernels`)."""
    import cv2

    from litepi_tpu_torch.apps import stream

    t0 = time.perf_counter()
    d = os.path.join(root, "stream")
    os.makedirs(os.path.join(d, "folder"))
    video = os.path.join(d, "clip.mp4")
    jpegs = sample_images(img_dir)[:STREAM_VIDEO_FRAMES]
    h, w = cv2.imread(jpegs[0]).shape[:2]
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
    for p in jpegs:
        writer.write(cv2.imread(p))
    writer.release()
    cap = cv2.VideoCapture(video)
    video_frames = [cap.read()[1] for _ in range(STREAM_VIDEO_FRAMES)]
    cap.release()
    for p in jpegs[:STREAM_FOLDER_FRAMES]:
        shutil.copy(p, os.path.join(d, "folder"))
    folder_frames = [cv2.imread(p) for p in sorted(jpegs[:STREAM_FOLDER_FRAMES])]
    # phase 10's classifier with its Dense x300: peaked probabilities, so
    # that the two runs' labels are not within rounding noise of a tie
    clf = os.path.join(d, "shufflenetv2_peaked.pth")
    state = torch.load(art["pth"], map_location="cpu", weights_only=True)
    state["fc.weight"] = state["fc.weight"] * 300.0
    torch.save(state, clf)
    weights = ["--detector", art["pt"], "--classifier", clf, "--clf_arch", "shufflenetv2"]

    # the threshold: candidate scores through the app's own pipeline
    pipes = {}
    for where in (dev.type, "cpu"):
        args = stream.build_arg_parser().parse_args([*weights, "--device", where])
        pipes[where] = stream.build_pipeline(args)
    # the threshold: the detections' scores at conf 0 (after NMS and the
    # min-area floor), each frame's in descending order; the detections over
    # a threshold c are those of them over c (a candidate under c suppresses
    # none over it)
    scores = {}
    for where, pipe in pipes.items():
        scores[where] = {}
        for mode, f in (("video", video_frames), ("folder", folder_frames)):
            out = pipe.run_fused(np.stack(f), 0.0)
            s_ = torch.where(out["valid"], out["det_scores"], -1.0).float().cpu().numpy()
            scores[where][mode] = -np.sort(-s_, axis=1)
    conf, half_gap, noise = stream_conf(scores["cpu"], scores[dev.type])
    # the bounds, measured on the app's own batches (video: batches of 8,
    # the last padded with its last frame; folder: one frame at a time) at
    # ``conf``: each side's bf16 program against its float32 program, and
    # the two float32 programs against each other.  Over the slots valid in
    # all four, |card bf16 - CPU bf16| <= |card bf16 - card f32| + |card
    # f32 - CPU f32| + |CPU f32 - CPU bf16| (the triangle inequality); the
    # middle term is held to STREAM_F32_TOL, so the two drifts plus
    # STREAM_F32_TOL bound the rows
    b = pipes["cpu"].cfg.batch_size
    batches = [np.stack((video_frames[i:i + b] + [video_frames[-1]] * b)[:b])
               for i in range(0, len(video_frames), b)]
    batches += [f[None] for f in folder_frames]
    det_vars = stream._detector_vars(art["pt"], pipes["cpu"].cfg.detector)
    cls_vars = stream._classifier_vars(args)
    outs = {}
    for where, p16 in pipes.items():
        p32 = TwoStagePipeline.from_jax_vars(p16.cfg, det_vars, cls_vars, torch.float32, where)
        for dtype, pipe in (("bf16", p16), ("f32", p32)):
            outs[where, dtype] = [{k: v.float().cpu() for k, v in pipe.run_fused(x, conf).items()}
                                  for x in batches]
        del p32
    pairs = {"card_drift": ((dev.type, "bf16"), (dev.type, "f32")),
             "f32_card_vs_cpu": ((dev.type, "f32"), ("cpu", "f32")),
             "cpu_drift": (("cpu", "bf16"), ("cpu", "f32"))}
    diffs = {name: {k: 0.0 for k in STREAM_F32_TOL} for name in pairs}
    for i in range(len(batches)):
        v = torch.stack([outs[key][i]["valid"] > 0 for key in outs]).all(0)
        if not bool(v.any()):
            continue
        for name, (x, y) in pairs.items():
            for k in STREAM_F32_TOL:
                gap = float((outs[x][i][k] - outs[y][i][k]).abs()[v].max())
                diffs[name][k] = max(diffs[name][k], gap)
    del outs
    f32 = diffs["f32_card_vs_cpu"]
    if any(not f32[k] <= tol for k, tol in STREAM_F32_TOL.items()):
        fail(f"stream app: the float32 programs differ card vs CPU by {f32}, "
             f"tolerance {STREAM_F32_TOL}")
    bounds = {k: diffs["card_drift"][k] + diffs["cpu_drift"][k] + tol
              for k, tol in STREAM_F32_TOL.items()}
    result = dict(conf=conf, half_gap=half_gap, score_noise=noise, differences=diffs,
                  bounds=bounds,
                  launches={})
    for mode, argv in (("video", ["--mode", "video", "--input", video]),
                       ("folder", ["--mode", "folder", "--input", os.path.join(d, "folder")])):
        rows = {}
        for where in (dev.type, "cpu"):
            out = os.path.join(d, f"{mode}_{where}")
            extra = (["--save_csv", os.path.join(out, "frames.csv"), "--save_video",
                      os.path.join(out, "out.mp4")] if mode == "video" else [])
            os.makedirs(out, exist_ok=True)
            full = [*argv, *weights, "--conf", repr(conf), "--output", out, "--device", where,
                    *extra]
            reset_launch_counts()
            t1 = time.perf_counter()
            run_cli(stream.main, full, f"stream app {mode} --device {where}")
            if where == dev.type:
                counts = launch_counts()
                result["launches"][mode] = counts
                result[f"{mode}_seconds"] = time.perf_counter() - t1
                if (counts["nms_suppress"] < 1 or counts["roi_crop_dense"] < 1 or counts["stem"]
                        or counts["roi_crop_pyramid"] or counts["roi_crop_pyramid_bf16"]):
                    fail(f"stream app {mode}: launch counts {counts}")
            rows[where] = stream_rows(os.path.join(
                out, "frames.csv" if mode == "video" else "detections.csv"))
        n = compare_stream_rows(rows[dev.type], rows["cpu"], bounds, f"stream app {mode}")
        if n == 0:
            fail(f"stream app {mode}: no detection at conf {conf}")
        result[f"{mode}_detections"] = n
    cap = cv2.VideoCapture(os.path.join(d, f"video_{dev.type}", "out.mp4"))
    written = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    if written != STREAM_VIDEO_FRAMES:
        fail(f"stream app video: the VideoWriter file holds {written} frames")
    first = torch.from_numpy(np.stack(video_frames[: pipes[dev.type].cfg.batch_size])).to(dev)
    result["kernel_checks"] = check_path_kernels(pipes[dev.type], first, None, "stream app")
    result["seconds"] = time.perf_counter() - t0
    print(f"stream phase (video and folder modes card vs CPU): {result['seconds']:.1f} s; "
          f"conf {conf:.6f}, bounds {bounds}, {result['video_detections']} / "
          f"{result['folder_detections']} detection rows equal")
    return result


# --------------------------------------------------------------------- #
# the ladder, the ablation CLI and the report CLI                        #
# --------------------------------------------------------------------- #

def ladder_phase(dev) -> dict:
    """``bench/ladder.py``'s levels L0-L4 on the card over
    ``make_synthetic_dataset`` (LADDER_FRAMES frames of 640x640), the launch
    counts zeroed just before and read just after: K1 at least once, K2
    dense and K3 at least once (the fused levels on canvas-sized frames);
    each level's FPS, latency and accuracy printed.  Then K1, K2 and K3
    against their plain versions on the L3 pipeline's first batch."""
    from litepi_tpu_torch.bench import ladder

    t0 = time.perf_counter()
    exp = ladder.OptimizationExperiment(device=dev)
    exp.use_synthetic_dataset(n=LADDER_FRAMES)
    reset_launch_counts()
    results = exp.run_all_levels(warmup=1, iterations=LADDER_ITERATIONS)
    counts = launch_counts()
    if counts["nms_suppress"] < 1 or counts["roi_crop_dense"] < 1 or counts["stem"] < 1:
        fail(f"ladder: launch counts {counts}")
    if set(results) != {spec.name for spec in ladder.LEVELS}:
        fail(f"ladder: levels {sorted(results)}")
    report = exp.generate_comparison_report()
    print(report)
    spec = next(s for s in ladder.LEVELS if s.name == "Level 3")
    pipe = exp._get_pipeline(spec)
    frames = torch.from_numpy(exp._frames[: spec.batch]).to(dev)
    checks = check_path_kernels(pipe, frames, None, "ladder L3")
    stem_err = dict(f32_err=0.0, bf16_err=0.0, bf16_ulps=0.0)
    with torch.inference_mode():
        got = fused_stem(frames, pipe._stem_kernel, pipe._stem_bias, pipe.dtype,
                         pipe._stem_params)
        want = stem_plain(frames, pipe._stem_kernel, pipe._stem_bias, pipe.dtype)
    torch.cuda.synchronize()
    stem_error(stem_err, got, want, "ladder L3 frames")
    checks["stem_bf16_max_abs_err"], checks["stem_bf16_ulps"] = (stem_err["bf16_err"],
                                                                 stem_err["bf16_ulps"])
    result = dict(levels=results, launches=counts, kernel_checks=checks,
                  seconds=time.perf_counter() - t0)
    print(f"ladder phase (L0-L4 on {LADDER_FRAMES} synthetic 640x640 frames): "
          f"{result['seconds']:.1f} s; launches {counts}")
    return result


def ablation_phase(dev, root: str) -> dict:
    """``apps/ablation.py`` on the card: static + ``--bench`` over the
    reference grid at 640 (params, FlopCounterMode GFLOPs, forward FPS at
    batch 32), then ``--train`` for one variant (w0.5 / d0.33) and one
    epoch on synthetic labelled frames; its launch counts (the training
    CLI's validation: K1) zeroed before and read after."""
    import csv

    from litepi_tpu_torch.apps import ablation

    t0 = time.perf_counter()
    out = os.path.join(root, "ablation")
    run_cli(ablation.main, ["--bench", "--output", out, "--device", dev.type],
            "ablation static + --bench")
    with open(os.path.join(out, "ablation_results.csv")) as f:
        rows = list(csv.DictReader(f))
    if len(rows) != 4 or not all(float(r["fps"]) > 0 and float(r["gflops"]) > 0 for r in rows):
        fail(f"ablation: rows {rows}")
    img_dir, lbl_dir = write_detection_set(os.path.join(root, "abl_data"), ABLATION_IMAGES,
                                           np.random.default_rng(44))
    reset_launch_counts()
    train_out = os.path.join(root, "ablation_train")
    run_cli(ablation.main, ["--widths", "0.5", "--depths", "0.33", "--extra", "", "--train",
                            "--images", img_dir, "--labels", lbl_dir, "--epochs", "1",
                            "--output", train_out, "--device", dev.type, "--train_args",
                            f"--batch {TRAIN_DET_BATCH} --steps_per_epoch 2 --max_gt 64"],
            "ablation --train")
    counts = launch_counts()
    with open(os.path.join(train_out, "ablation_results.csv")) as f:
        (trained,) = list(csv.DictReader(f))
    if trained["map50"] == "" or trained["best_epoch"] != "1" or counts["nms_suppress"] < 1:
        fail(f"ablation --train: row {trained}, launches {counts}")
    result = dict(rows=rows, train_row=trained, train_launches=counts,
                  seconds=time.perf_counter() - t0)
    print(f"ablation phase: {result['seconds']:.1f} s; {json.dumps(rows)}")
    return result


def report_phase(root: str, eval_dir: str) -> dict:
    """``apps/report.py`` over an evaluation output directory (the e2e CLI
    phase's run at its defaults): rc 0, the LaTeX table and the summary
    report written; figures only where matplotlib exists."""
    from litepi_tpu_torch.apps import report

    out = os.path.join(root, "report")
    text = run_cli(report.main, ["--input", eval_dir, "--output", out], "report CLI")
    files = sorted(os.listdir(out))
    if not {"comparison_table.tex", "summary_report.txt"} <= set(files) \
            or "PIPELINE COMPARISON SUMMARY" not in text:
        fail(f"report CLI: wrote {files}")
    return dict(files=files)



# --------------------------------------------------------------------- #
# data parallelism: the mesh, MeshServer, the multi-rank flow            #
# --------------------------------------------------------------------- #

def dp_nccl_mesh_checks(dev, smi: str) -> dict:
    """In this process, one NCCL rank on ``dev`` (a 1-rank group of its own):
    ``MeshServer.serve`` at the serving configuration (B=DP_SERVE_BATCH
    640x640 device frames, bf16) issued under ``set_sync_debug_mode("error")``
    with the launch counts zeroed just before and read just after (K1, K2
    dense and K3 once each), bit-equal to ``pipe.run_fused`` on the same
    frames, both timed (ms per batch, the median of WINDOWS windows); a
    ``StreamingRunner(server=...)`` over DP_STREAM_BATCHES batches of
    canvases against the direct run + host unmap (discrete outputs equal,
    floats within 1e-5, the streaming check's bounds); and the bf16
    detector train step at full width (yolo_plus_v2, 640, B=16) with the
    mesh, its launches counted (the act kernel both ways), its first loss
    bit-equal to the step without a mesh from the same weights."""
    import datetime

    import torch.distributed as dist

    from litepi_tpu_torch.parallel.mesh import make_mesh
    from litepi_tpu_torch.pipeline.serving import MeshServer

    result, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "rendezvous"),
                                rank=0, world_size=1, timeout=datetime.timedelta(seconds=300),
                                device_id=dev)
        try:
            mesh = make_mesh(backend="cuda")
            if mesh.shape != {"data": 1, "model": 1} or mesh.device != dev:
                fail(f"1-rank NCCL mesh: {mesh.shape} on {mesh.device}")
            b = DP_SERVE_BATCH
            cfg = dataclasses.replace(SERVING, cls_crop_budget=4 * b)
            pipe = TwoStagePipeline.initialize(cfg, seed=0, dtype=torch.bfloat16, device=dev)
            server = MeshServer(pipe, mesh)
            gen = torch.Generator(device=dev).manual_seed(31)
            frames = torch.randint(0, 256, (b, 640, 640, 3), generator=gen, device=dev,
                                   dtype=torch.uint8)
            area = torch.ones(b, device=dev)
            server.serve(frames, area_scale=area)  # warm-up
            torch.cuda.synchronize()
            out, counts = issue_sync_free(lambda: server.serve(frames, area_scale=area),
                                          f"MeshServer.serve b={b} (1 NCCL rank)")
            for name in ("nms_suppress", "roi_crop_dense", "stem"):
                if counts[name] != 1:
                    fail(f"MeshServer.serve launched {name} {counts[name]} times, not once")
            launches["serve"] = counts
            want = pipe.run_fused(frames, area_scale=area)
            check_outputs(out, b, cfg.crop_det_budget, 640, 640, cfg.num_classifier_classes,
                          "MeshServer.serve")
            for k, v in want.items():
                if not torch.equal(out[k], v):
                    fail(f"MeshServer.serve (1 rank): {k} is not bit-equal to run_fused")
            serve_ms, serve_windows = median_ms(lambda: server.serve(frames, area_scale=area), 20, 2)
            fused_ms, fused_windows = median_ms(lambda: pipe.run_fused(frames, area_scale=area),
                                                20, 2)
            result["serve"] = dict(batch=b, ms_per_batch=serve_ms, windows_ms=serve_windows,
                                   run_fused_ms_per_batch=fused_ms,
                                   run_fused_windows_ms=fused_windows, bit_equal=True,
                                   sync_free=True, valid=int(out["valid"].sum()), card=smi)
            print(f"MeshServer.serve, 1 NCCL rank, b={b} 640x640 bf16: sync-free, bit-equal "
                  f"to run_fused; {serve_ms:.3f} ms/batch (windows {serve_windows}) beside "
                  f"run_fused {fused_ms:.3f} (windows {fused_windows}); {smi}")

            result["stream"], launches["stream"] = dp_stream_check(dev, pipe, server)
            del pipe, server, frames, out, want
            result["train_step"], launches["train_step"] = dp_train_step(dev, mesh)
        finally:
            dist.destroy_process_group()
    return {"nccl_1_rank": result, "launches": launches}


def dp_stream_check(dev, pipe, server):
    """DP_STREAM_BATCHES batches of B=DP_SERVE_BATCH canvases of a
    STREAM_SOURCE frame through ``StreamingRunner(server=server)`` against
    ``pipe.run_fused`` + the host unmap of the same canvases."""
    b, s = DP_SERVE_BATCH, pipe.cfg.det_input_size
    src_h, src_w = STREAM_SOURCE
    ratio, dw, dh, (new_w, new_h), (top, _, left, _) = letterbox_params(src_h, src_w, s)
    geoms = np.tile(np.array([ratio, dw, dh, src_w, src_h], np.float32), (b, 1))
    rng = np.random.default_rng(8)
    canvases = []
    for _ in range(2):
        c = np.full((b, s, s, 3), 114, np.uint8)
        c[:, top : top + new_h, left : left + new_w] = rng.integers(
            0, 256, (b, new_h, new_w, 3), dtype=np.uint8)
        canvases.append(c)
    area = torch.from_numpy(area_scale_of(geoms)).to(dev)
    refs = []
    for c in canvases:
        out = {k: v.cpu().numpy() for k, v in
               pipe.run_fused(torch.from_numpy(c).to(dev), area_scale=area).items()}
        out["boxes"] = unmap_boxes(out["boxes"], geoms)
        refs.append(out)
    runner = RamStreamingRunner(pipe, canvases, geoms, batch_size=b, inflight=2, server=server)
    paths = [f"ram://{i}" for i in range(DP_STREAM_BATCHES * b)]
    reset_launch_counts()
    results = list(runner.run(paths))
    counts = launch_counts()
    runner.close()
    if len(results) != DP_STREAM_BATCHES or counts["stem"] != DP_STREAM_BATCHES:
        fail(f"stream through MeshServer: {len(results)} batches, stem {counts['stem']} times")
    for i, (_, out) in enumerate(results):
        for k, v in refs[i % 2].items():
            if k in ("valid", "det_class_ids", "cls_labels"):
                if not np.array_equal(out[k], v):
                    fail(f"stream through MeshServer, batch {i}: {k} differs from run_fused")
            elif not float(np.abs(out[k].astype(np.float64) - v).max()) <= 1e-5:
                fail(f"stream through MeshServer, batch {i}: {k} differs by more than 1e-5")
    print(f"StreamingRunner(server=MeshServer): {DP_STREAM_BATCHES} batches of {b} equal to "
          f"run_fused + host unmap; launches {counts}")
    return dict(batches=DP_STREAM_BATCHES, batch=b, equal=True), counts


def dp_train_step(dev, mesh):
    """The bf16 detector step at full width with the 1-rank mesh: launches
    counted over DP_TRAIN_STEPS steps, the first loss bit-equal to the step
    without a mesh from the same weights and batch."""
    cfg = dataclasses.replace(YOLO_PLUS_V2, input_size=TRAIN_DET_SIZE)
    batch = detector_batch(dev, TRAIN_DET_BATCH, TRAIN_DET_SIZE,
                           torch.Generator(device=dev).manual_seed(23))
    losses = {}
    for tag, m in (("plain", None), ("mesh", mesh)):
        model, state, tx = create_detector_train_state(cfg, seed=0, total_steps=100,
                                                        warmup_steps=10, device=dev)
        reset_launch_counts()
        steps = []
        for _ in range(DP_TRAIN_STEPS):
            state, metrics = detector_train_step(model, tx, state, batch, cfg=cfg, mesh=m)
            steps.append(metrics["loss"])
        counts = launch_counts()
        losses[tag] = [float(v) for v in steps]
        del model, state
    if losses["mesh"][0] != losses["plain"][0] or not np.isfinite(losses["mesh"]).all():
        fail(f"bf16 train step with the 1-rank mesh: losses {losses}")
    if counts["silu_bf16"] < 1 or counts["silu_bf16_bwd"] < 1:
        fail(f"bf16 train step with the mesh launched no act kernel: {counts}")
    print(f"bf16 detector step with the 1-rank mesh ({TRAIN_DET_SIZE}x{TRAIN_DET_SIZE}, "
          f"B={TRAIN_DET_BATCH}): losses {losses['mesh']} (first bit-equal to the step "
          f"without a mesh: {losses['plain']}); launches {counts}")
    return dict(losses=losses, steps=DP_TRAIN_STEPS), counts


def dp_gloo_flow(dev) -> tuple:
    """``parallel/multiprocess.py``'s flow on the card: 1 and 2 gloo ranks
    sharing it (a correctness check, never a throughput number): the
    float32 served outputs' discrete values equal, floats within the
    float32 tolerances, the train loss and parameter checksum within 1e-6
    relative.  Returns the runs' scalars and the ranks' launch counts."""
    from litepi_tpu_torch.parallel.multiprocess import run_multiprocess_dryrun

    t0 = time.perf_counter()
    res = run_multiprocess_dryrun(2, device="cuda", backend="gloo", timeout=DP_FLOW_TIMEOUT)
    seconds = time.perf_counter() - t0
    single, multi = res["single"], res["multi"]
    launches = {k: single["launches"][k] + multi["launches"][k] for k in single["launches"]}
    for name in ("nms_suppress", "roi_crop_dense", "stem"):
        if single["launches"][name] < 1 or multi["launches"][name] < 1:
            fail(f"the 2-rank flow on the card did not launch {name}: {launches}")
    served = multi["served"]
    r = dict(seconds=seconds, loss_1_rank=single["loss"], loss_2_ranks=multi["loss"],
             param_sum_1_rank=single["param_sum"], param_sum_2_ranks=multi["param_sum"],
             valid=int(served["valid"].sum()),
             max_abs_diff={k: float(np.abs(single["served"][k].astype(np.float64)
                                           - served[k]).max())
                           for k in ("boxes", "det_scores", "cls_probs", "cls_scores")},
             rank0_launches_1_rank=single["launches"], rank0_launches_2_ranks=multi["launches"])
    print(f"2 gloo ranks sharing the card vs 1 rank (float32, TF32 off): {json.dumps(r)}")
    return r, launches


def dp_cli_checks(dev, root: str) -> dict:
    """The training CLI's launcher: ``--data_parallel 1`` on the card (its
    launches counted, validation's K1 at K=512 among them),
    ``--data_parallel 2 --device cuda`` on a one-card machine (rc 2, no
    training), and 2 CPU ranks (gloo) against 1, one step in the CLI's
    bf16: the loss within one bf16 ulp (the ranks reduce in another order,
    and the CPU's bf16 convolutions may round a batch of 2 otherwise than
    one of 4); the weights' largest difference after the update is
    recorded in bf16 ulps of each tensor's largest magnitude."""
    import contextlib
    import io

    from litepi_tpu_torch.apps import train_detector

    rng = np.random.default_rng(41)
    img_dir, lbl_dir = write_detection_set(os.path.join(root, "dp_train"), 8, rng)
    base = ["--images", img_dir, "--labels", lbl_dir, "--imgsz", "160", "--batch", "4",
            "--epochs", "1", "--patience", "99", "--max_gt", "8"]
    reset_launch_counts()
    run_cli(train_detector.main, base + ["--val_images", img_dir, "--val_labels", lbl_dir,
                                         "--output", os.path.join(root, "dp1_cuda"),
                                         "--data_parallel", "1"],
            "train_detector --data_parallel 1 (card)")
    counts = launch_counts()
    if counts["silu_bf16_bwd"] < 1 or counts["nms_suppress"] < 1:
        fail(f"train_detector --data_parallel 1 on the card: launches {counts}")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = train_detector.main(base + ["--output", os.path.join(root, "dp2_refused"),
                                         "--data_parallel", str(torch.cuda.device_count() + 1)])
    if rc != 2 or "visible" not in err.getvalue():
        fail(f"--data_parallel beyond the cards: rc {rc}, {err.getvalue()!r}")
    losses, weights = {}, {}
    for n in (1, 2):
        out = os.path.join(root, f"dp{n}_cpu")
        run_cli(train_detector.main, base + ["--output", out, "--device", "cpu",
                                             "--steps_per_epoch", "1", "--data_parallel", str(n)],
                f"train_detector --data_parallel {n} --device cpu")
        saved = torch.load(os.path.join(out, "resume", "variables.pt"), weights_only=True)
        losses[n], weights[n] = -saved["meta"]["best_score"], saved["model"]
    if not abs(losses[2] - losses[1]) <= math.ldexp(1.0, math.frexp(losses[1])[1] - 8):
        fail(f"train_detector on 2 CPU ranks vs 1: losses {losses} more than one bf16 ulp apart")
    # recorded, not held: the weights after the update, in bf16 ulps of each
    # tensor's largest magnitude (whole ulps apart where the CPU's bf16
    # convolutions round the two batch sizes otherwise)
    weight_ulps = max(
        ((weights[2][k].double() - v.double()).abs().max()
         / math.ldexp(1.0, math.frexp(max(v.double().abs().max().item(),
                                          weights[2][k].double().abs().max().item()))[1] - 8)
         ).item() for k, v in weights[1].items())
    r = dict(card_launches=counts, refused_rc=rc, cpu_losses=losses,
             cpu_weights_bf16_ulps=weight_ulps)
    print(f"train_detector launcher: {json.dumps(r)}")
    return r, counts


def data_parallel_phase(dev, root: str, smi: str) -> dict:
    """Data-parallel serving and training (``parallel/``, ``pipeline/
    serving.py``, ``data/distributed.py``); see step 14 of the module
    docstring.  Returns the results and the phase's launch counts by run."""
    t0 = time.perf_counter()
    nccl = dp_nccl_mesh_checks(dev, smi)
    flow, flow_launches = dp_gloo_flow(dev)
    cli, cli_launches = dp_cli_checks(dev, root)
    runs = {**nccl["launches"], "gloo_flow": flow_launches, "train_cli": cli_launches}
    total = {k: sum(c[k] for c in runs.values()) for k in flow_launches}
    seconds = time.perf_counter() - t0
    print(f"data-parallel phase: {seconds:.1f} s; launches {total}")
    return dict(nccl_1_rank=nccl["nccl_1_rank"], gloo_2_ranks=flow, train_cli=cli,
                launches=total, launches_by_run=runs, seconds=seconds)


def stream_counts(stream: dict) -> dict:
    """The stream phase's card launches, video and folder summed."""
    runs = stream["launches"].values()
    return {k: sum(r[k] for r in runs) for k in next(iter(runs))}


def by_row(counts: dict, nms_row: str, dense_row: str) -> dict:
    """A path's launch counts on the kernels line's rows: K1 on the row of
    its K, K2 dense on the row of its frames, the rest by name (the act
    kernel's backward on ``act_bf16_bwd``)."""
    rows = {nms_row: counts["nms_suppress"], dense_row: counts["roi_crop_dense"],
            "act_bf16_bwd": counts["silu_bf16_bwd"]}
    for name in ("roi_crop_pyramid", "roi_crop_pyramid_bf16", "stem", "silu_bf16",
                 "silu_bias_bf16", "bn_silu_bf16", "sigmoid_bf16"):
        rows[name] = counts[name]
    return rows


def run(dev) -> None:
    """Every phase on ``dev``; prints the kernels and e2e JSON lines and the
    card's name and power limit.  Raises on any failure."""
    smi = nvidia_smi()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    paths = build_kernels()
    print_resources(paths, smi, "before the timed windows")

    nms = check_nms(dev)
    nms_large = check_nms_large(dev)
    roi = check_roi(dev)
    stem = check_stem(dev)
    acts = check_act(dev)
    vocab = check_vocab(dev)
    world = world_path(dev)
    adown = check_adown(dev)
    v9 = v9_path(dev)
    for seed, h, w in SMALL_SCENES:
        check_small_pipeline(dev, seed, h, w)
    tf32 = check_tf32_scope(dev)
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
    ladder = ladder_phase(dev)
    with tempfile.TemporaryDirectory() as root:
        cli, files = e2e_cli_phase(dev, root)
        convert = convert_phase(dev, cli, files, root)
        stream = stream_phase(dev, root, files["art"], files["img_dir"])
        report = report_phase(root, os.path.join(root, "defaults"))
        training = training_phase(dev, root)
        ablation = ablation_phase(dev, root)
        baselines = baselines_phase(dev, root, smi)
        data_parallel = data_parallel_phase(dev, root, smi)
    eval_counts = evaluation["full"]["launches"]
    eval_checks = evaluation["full"]["kernel_checks"]
    smi_after = nvidia_smi()
    print_resources(paths, smi_after, "after the timed windows")

    zoo_launches = {name: {f"{z['detector']}+{z['classifier']}": z["launches"][name] for z in zoo}
                    for name in ("nms_suppress", "roi_crop_dense", "stem", "silu_bf16",
                                 "silu_bias_bf16", "sigmoid_bf16", "bn_silu_bf16", "bn_bf16")}

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
                     "silu_bias_bf16": eval_counts["silu_bias_bf16"],
                     "bn_silu_bf16": eval_counts["bn_silu_bf16"],
                     "sigmoid_bf16": eval_counts["sigmoid_bf16"],
                     "act_bf16_bwd": eval_counts["silu_bf16_bwd"]}
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
                    "silu_bias_bf16": cli_sum("silu_bias_bf16"),
                    "bn_silu_bf16": cli_sum("bn_silu_bf16"),
                    "sigmoid_bf16": cli_sum("sigmoid_bf16"),
                    "act_bf16_bwd": cli_sum("silu_bf16_bwd")}
    # the convert phase's full-width e2e run over the emitted NCNN pairs
    conv_counts = convert["e2e"]["launches"]
    convert_launches = {"nms_suppress": 0, "nms_suppress_k512": conv_counts["nms_suppress"],
                        "roi_crop_dense": 0, "roi_crop_dense_b8": conv_counts["roi_crop_dense"],
                        **{k: conv_counts[k] for k in ("roi_crop_pyramid", "roi_crop_pyramid_bf16",
                                                       "stem", "silu_bf16", "silu_bias_bf16",
                                                       "bn_silu_bf16", "sigmoid_bf16")},
                        "act_bf16_bwd": conv_counts["silu_bf16_bwd"]}
    cli_checks = {"dense": cli["full_dense"]["kernel_checks"],
                  "pyramid_bf16": cli["full_bf16_pallas"]["kernel_checks"]}

    train, bwd = training, training["act_backward"]
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
              convert_nms_mismatches=convert["e2e"]["kernel_checks"]["nms_mismatches"],
              train_nms_mismatches=train["validation_nms"]["nms_mismatches"]),
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
        # the bias mode: a deploy-form conv's bias add folded into the SiLU
        # (launches: every ConvBN of the main path's bf16 runs)
        entry("silu_bias_bf16", "act.cu", "none: port-only (a biased flax nn.Conv's bias add "
              "and flax nn.silu in bf16, litepi_tpu/models/layers.py:53-71)",
              counts["silu_bias_bf16"], acts["silu_bias_bf16"]["nchw"], 0.0,
              "x".join(map(str, acts["silu_bias_bf16"]["nchw"]["shape"])) + " NCHW",
              library="the biased conv's ATen bias add + the SiLU pass",
              two_pass_ms=acts["silu_bias_bf16"]["nchw"]["two_pass_ms"],
              channels_last=acts["silu_bias_bf16"]["channels_last"],
              zoo_launches=zoo_launches["silu_bias_bf16"]),
        # the BatchNorm mode: an injected detector's eval BatchNorm and the
        # SiLU after it (launches: the zoo's YOLOv11n run; the main path's
        # detector has its BatchNorm folded)
        entry("bn_silu_bf16", "act.cu", "none: port-only (flax nn.BatchNorm and nn.silu in "
              "bf16, litepi_tpu/models/layers.py:63-71)",
              zoo_launches["bn_silu_bf16"]["yolov11n+resnet18"],
              acts["bn_silu_bf16"]["x".join(map(str, ACT_BN_SHAPES[0]))], 0.0,
              "x".join(map(str, ACT_BN_SHAPES[0])) + " channels last",
              library="ATen's eval BatchNorm + the SiLU pass",
              yolo12=acts["bn_silu_bf16"]["x".join(map(str, ACT_BN_SHAPES[1]))],
              zoo_launches=zoo_launches["bn_silu_bf16"],
              zoo_launches_alone=zoo_launches["bn_bf16"]),
        # its path is the zoo's EfficientNet-B0 run (the main path has no gate)
        entry("sigmoid_bf16", "act.cu", "none: port-only (flax nn.sigmoid in bf16, "
              "litepi_tpu/models/efficientnet.py:55)",
              zoo_launches["sigmoid_bf16"]["yolov5n_legacy+efficientnet"], acts["sigmoid_bf16"],
              acts["sigmoid_bf16"]["max_abs_err"], "x".join(map(str, ACT_SIGMOID_SHAPE)),
              library="torch.sigmoid (one rounding)", max_ulps=acts["sigmoid_bf16"]["max_ulps"],
              mismatch_share=acts["sigmoid_bf16"]["mismatch_share"],
              zoo_launches=zoo_launches["sigmoid_bf16"]),
        # the backward mode (SiLU; sigmoid checked too): its path is the
        # training phase's bf16 train steps
        entry("act_bf16_bwd", "act.cu", "none: port-only (jax.vjp of flax nn.silu / nn.sigmoid "
              "in bf16, litepi_tpu/models/layers.py:71)", train["train_launches"]["silu_bf16_bwd"],
              bwd, 0.0, "x".join(map(str, ACT_BWD_SHAPE)) + ", SiLU mode",
              library="torch.ops.aten.silu_backward (one rounding)",
              mismatches=bwd["mismatches"], elements_checked=bwd["elements"],
              sigmoid_mode_launches=bwd["sigmoid_mode_launches"]),
    ]
    # the training phase's launches (both CLIs, zeroed before each): K1 at
    # K=512 (validation's detect), the bf16 SiLU forward and backward
    tl = train["train_launches"]
    train_launches = {"nms_suppress": 0, "nms_suppress_k512": tl["nms_suppress"],
                      "roi_crop_dense": 0, "roi_crop_dense_b8": tl["roi_crop_dense"],
                      "roi_crop_pyramid": tl["roi_crop_pyramid"],
                      "roi_crop_pyramid_bf16": tl["roi_crop_pyramid_bf16"], "stem": tl["stem"],
                      "silu_bf16": tl["silu_bf16"], "silu_bias_bf16": tl["silu_bias_bf16"],
                      "bn_silu_bf16": tl["bn_silu_bf16"],
                      "sigmoid_bf16": tl["sigmoid_bf16"],
                      "act_bf16_bwd": tl["silu_bf16_bwd"]}
    for k in kernels:
        k["eval_launches"] = eval_launches[k["name"]]
        k["e2e_cli_launches"] = cli_launches[k["name"]]
        k["convert_launches"] = convert_launches[k["name"]]
        k["train_launches"] = train_launches[k["name"]]
    # the baselines phase's launches (both CLIs, both checkpoint benches, the
    # fair benchmark): the RPN row holds K1's total over every K of the phase
    # (1,024: the RPN, the evaluations' class-aware NMS; 256: the final NMS,
    # the YOLO variants), split by K in baseline_launches_by_k
    bl = baselines["launches"]
    baseline_launches = {"nms_suppress": 0, "nms_suppress_k512": 0,
                         "nms_suppress_rpn_k1024": bl["nms_suppress"],
                         "roi_crop_dense": 0, "roi_crop_dense_b8": bl["roi_crop_dense"],
                         "roi_crop_pyramid": bl["roi_crop_pyramid"],
                         "roi_crop_pyramid_bf16": bl["roi_crop_pyramid_bf16"], "stem": bl["stem"],
                         "silu_bf16": bl["silu_bf16"], "silu_bias_bf16": bl["silu_bias_bf16"],
                         "bn_silu_bf16": bl["bn_silu_bf16"],
                         "sigmoid_bf16": bl["sigmoid_bf16"],
                         "act_bf16_bwd": bl["silu_bf16_bwd"]}
    rpn = baselines["inference"]["faster_rcnn"]
    kernels.insert(2, entry(
        "nms_suppress_rpn_k1024", "nms.cu", nms_at, bl["nms_suppress"], rpn["rpn_nms_timing"], 0,
        "B={} K={}, 1 class, Faster R-CNN RPN proposals".format(*rpn["rpn_nms"]["shape"]),
        baseline_launches_by_k=baselines["k1_launches_by_k"],
        baseline_cluster_launches_by_k=baselines["k1_cluster_launches_by_k"],
        rpn_valid=rpn["rpn_nms"]["valid"], rpn_kept=rpn["rpn_nms"]["kept"],
        final_nms_mismatches={k: v["final_nms"]["mismatches"]
                              for k, v in baselines["inference"].items()},
        eval_launches=0, e2e_cli_launches=0, convert_launches=0, train_launches=0))
    for k in kernels:
        k["baseline_launches"] = baseline_launches[k["name"]]
    # K1 above 1,024 candidates and at the stream app's budget, a row per
    # shape: (8, 8,400) the e2e CLI at --max_candidates 8400, (8, 2,000) the
    # baseline CLI at --pre_nms_topk 2000, (8, 256) the stream app, (128,
    # 2,048) a timing shape no path runs; greedy_cluster_launches: those of
    # the row's launches whose greedy pass ran on a thread-block cluster
    # (nms_greedy_cluster_kernel)
    cli_k = cli["full_k8400"]
    k2000 = baselines["k2000_cli_launches_by_k"]
    k2000_cluster = baselines["k2000_cli_cluster_launches_by_k"]
    for name, key, launches, extra in (
            ("nms_suppress_k256", "8x256", stream_counts(stream)["nms_suppress"],
             dict(stream_nms_mismatches=stream["kernel_checks"]["nms_mismatches"])),
            ("nms_suppress_k2000", "8x2000", k2000.get(str(BASE_LARGE_PRE_NMS), 0),
             dict(baseline_k2000_launches_by_k=k2000,
                  greedy_cluster_launches=k2000_cluster.get(str(BASE_LARGE_PRE_NMS), 0),
                  baseline_k2000_cluster_launches_by_k=k2000_cluster,
                  rpn_k2000=baselines["card_vs_cpu"]["frcnn_forward_k2000"])),
            ("nms_suppress_k8400", "8x8400", cli_k["k1_launches_by_k"].get(str(E2E_CLI_LARGE_K), 0),
             dict(e2e_cli_k8400_launches_by_k=cli_k["k1_launches_by_k"],
                  greedy_cluster_launches=cli_k["k1_cluster_launches_by_k"].get(
                      str(E2E_CLI_LARGE_K), 0),
                  e2e_cli_k8400_cluster_launches_by_k=cli_k["k1_cluster_launches_by_k"],
                  e2e_cli_k8400_nms_mismatches=cli_k["kernel_checks"]["nms_mismatches"],
                  e2e_cli_k8400_valid=cli_k["kernel_checks"]["nms_valid"])),
            ("nms_suppress_b128_k2048", "128x2048", 0, {})):
        r = nms_large[key]
        b, k = key.split("x")
        kernels.append(entry(name, "nms.cu", nms_at, launches, r, 0, f"B={b} K={k}, 1 class",
                             device_ms_by_kernel=r["device_ms_by_kernel"], **extra))
    # port-only: YOLO-World's class head, no JAX counterpart; launches are
    # those of one run_fused of the YOLO-World cell's pipeline (world_path;
    # serving runs none)
    kernels.append(entry(
        "vocab_gemm", "vocab.cu", "none: port-only (YOLO-World's contrastive class head, which "
        "the JAX package does not have)", world["launches"]["vocab_gemm"], vocab,
        vocab["max_abs_err"],
        "B=32 K=512 at 160x160, 80x80 and 40x40, nc=1203 (the YOLO-World cell's levels)",
        library="cuDNN's class conv + ATen's bias add + the float32 copy",
        mismatch_share=vocab["mismatch_share"], max_ulps=vocab["max_ulps"],
        levels=vocab["levels"]))
    # port-only: YOLOv9's ADown front end, no JAX counterpart; launches are
    # those of one run_fused of the YOLOv9-E cell's pipeline (v9_path;
    # serving runs none)
    kernels.append(entry(
        "adown", "adown.cu", "none: port-only (YOLOv9's ADown, which the JAX package does not "
        "have)", v9["launches"]["adown"], adown, 0.0,
        "the YOLOv9-E cell's 8 ADown inputs: B=32 C=256 320x320, 512 160x160, 1024 80x80 "
        "(twice each), 256 160x160, 512 80x80",
        library="ATen's avg_pool2d, x1 made dense, max_pool2d with indices (the parent's path)",
        shapes=adown["shapes"]))
    kernels[2]["synthetic_8x1024"] = {k: nms_large["8x1024"][k] for k in (  # the RPN row
        "ms", "device_ms", "host_ms", "plain_ms", "device_ms_by_kernel")}
    # the new paths' launches (each zeroed before its runs and summed): the
    # stream app (video + folder), the ladder (L0-L4), the ablation CLI's
    # --train run; K1 at each path's own K, K2 dense on its own frames
    paths = {"stream_launches": (stream_counts(stream), "nms_suppress_k256", "roi_crop_dense_b8"),
             "ladder_launches": (ladder["launches"], "nms_suppress_k512", "roi_crop_dense"),
             "ablation_launches": (ablation["train_launches"], "nms_suppress_k512",
                                   "roi_crop_dense")}
    for column, (counts, nms_row, dense_row) in paths.items():
        rows = by_row(counts, nms_row, dense_row)
        for k in kernels:
            k[column] = rows.get(k["name"], 0)
    for k in kernels:
        for column in ("eval_launches", "e2e_cli_launches", "convert_launches", "train_launches",
                       "baseline_launches"):
            k.setdefault(column, 0)
    # the data-parallel phase (each run zeroed before and summed): MeshServer,
    # its stream, the flow's served batches and the train steps at K=64 on
    # the serving rows; the training CLI's validation at K=512 and on its
    # own frames
    dp_runs = dict(data_parallel["launches_by_run"])
    dp_cli = dp_runs.pop("train_cli")
    dp_rows = by_row({k: sum(c[k] for c in dp_runs.values()) for k in dp_cli},
                     "nms_suppress", "roi_crop_dense")
    for name, n in by_row(dp_cli, "nms_suppress_k512", "roi_crop_dense_b8").items():
        dp_rows[name] = dp_rows.get(name, 0) + n
    for k in kernels:
        k["data_parallel_launches"] = dp_rows.get(k["name"], 0)
    row = {k["name"]: k for k in kernels}
    row["roi_crop_dense_b8"]["stream_max_abs_err"] = stream["kernel_checks"]["roi_max_abs_err"]
    row["roi_crop_dense"]["ladder_max_abs_err"] = ladder["kernel_checks"]["roi_max_abs_err"]
    row["stem"]["ladder_bf16_max_abs_err"] = ladder["kernel_checks"]["stem_bf16_max_abs_err"]
    row["nms_suppress_k512"]["ladder_nms_mismatches"] = ladder["kernel_checks"]["nms_mismatches"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"e2e": timings, "detect": detect, "streaming": streaming, "zoo": zoo,
                      "eval": evaluation, "e2e_cli": cli, "convert": convert,
                      "training": training, "baselines": baselines, "nms_large": nms_large,
                      "tf32": tf32, "stream": stream, "ladder": ladder, "ablation": ablation,
                      "report": report, "data_parallel": data_parallel,
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
