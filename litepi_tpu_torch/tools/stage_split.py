"""Where the fused program's time goes on the card: per-stage device times
and the device's idle share.

    python -m litepi_tpu_torch.tools.stage_split [--detector V] [--classifier A] [--batch B]

Builds the serving configuration at full width (yolo_plus_v2 +
ShuffleNetV2-91, B=128 640x640 BGR frames, bfloat16, 64 candidates, 16
detections, crop_det_budget 8, cls_crop_budget 4*B) with seeded random
weights, or with a zoo detector injected (``--detector yolov11n``,
``yolov5n``, ``yolov5n_legacy``), another classifier (``--classifier
resnet18``, ...) and another batch, then:

* times ``run_fused`` end to end in several back-to-back windows (CUDA
  events, after warm-up), so that the spread between windows shows;
* times each stage alone on the inputs the previous stage produced,
  through the pipeline's own stage methods, the ones ``run_fused`` calls:
  the stem (at this canvas size the stem kernel K3 on the uint8 frames,
  with no letterbox stage; for an injected detector the letterbox, x 1/255
  and nothing else), the rest of the detector (all of an injected one), decode + top-K,
  NMS + crop budget, box unmapping, ROI crop, classifier;
* traces a few ``run_fused`` calls with ``torch.profiler`` and sums device
  time by kind and by kernel name.  The idle share is read in that same
  window: 1 - device busy time / the window's CUDA-event time.  Tracing
  slows the host, so the traced window's time is printed beside the
  untraced one, and so is the count of stream synchronisations the host
  made per batch (each one drains the card's queue).

Prints one JSON line.  Exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys

import torch

BATCH = 128
DTYPE = torch.bfloat16
ITERS = 20  # calls per timing window
E2E_WINDOWS = 5
TRACED = 5  # run_fused calls in the traced window


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_windows(fn, iters: int, windows: int, warmup: int = 3) -> list:
    """:func:`cuda_ms` over ``windows`` back-to-back windows (warm-up once)."""
    return [cuda_ms(fn, iters, warmup if i == 0 else 0) for i in range(windows)]


def kernel_device_times(fn, iters: int, name: str) -> dict:
    """{kernel name: (mean device milliseconds, launches seen)} of the
    kernels whose name contains ``name``, from ``torch.profiler``'s CUDA
    activity over ``iters`` calls of ``fn`` after one untraced call.  The
    kernels' own duration on the card, whatever the host's issue rate;
    tracing slows the host, so this window is kept apart from the
    CUDA-event ones."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and name in ev.name:
            by_kernel.setdefault(ev.name, []).append(ev.time_range.elapsed_us())
    return {k: (sum(us) / len(us) / 1e3, len(us)) for k, us in by_kernel.items()}


def kernel_device_ms(fn, iters: int, name: str) -> tuple:
    """(device milliseconds per call, calls seen) of the kernels whose name
    contains ``name`` (:func:`kernel_device_times`).  Each such kernel
    launches once per call (K1 above K=64 launches two), so a call's time
    is the sum over the distinct kernels of each one's mean duration, and
    the calls seen are the fewest launches of any of them (the trace may
    drop a few)."""
    times = kernel_device_times(fn, iters, name)
    if not times:
        return float("nan"), 0
    return sum(ms for ms, _ in times.values()), min(n for _, n in times.values())


KINDS = (
    ("nms_kernel", ("nms_",)),  # nms_small_kernel, nms_mask_ and nms_greedy_kernel
    ("roi_kernel", ("roi_crop_kernel",)),
    ("stem_kernel", ("stem_tiled_kernel", "stem_generic_kernel")),
    ("conv_gemm", ("conv", "cudnn", "xmma", "gemm", "sm90_", "implicit", "cutlass",
                   "wgrad", "dgrad", "fprop")),
    ("sort_topk", ("sort", "radix", "topk")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def measure(dev, detector: str = "yolo_plus_v2", classifier: str = "shufflenetv2",
            batch: int = BATCH) -> dict:
    """Every measurement of the module docstring, on ``dev``."""
    from torch.profiler import ProfilerActivity, profile

    from litepi_tpu_torch.core.types import NMSConfig, PipelineConfig
    from litepi_tpu_torch.models import detector_kwargs
    from litepi_tpu_torch.pipeline import TwoStagePipeline

    cfg = PipelineConfig(
        nms=NMSConfig(max_candidates=64, max_detections=16),
        classifier_arch=classifier,
        input_color="bgr",
        crop_det_budget=8,
        cls_crop_budget=4 * batch,
    )
    zoo = {} if detector == "yolo_plus_v2" else detector_kwargs(detector, cfg, dev)
    pipe = TwoStagePipeline.initialize(cfg, seed=0, dtype=DTYPE, device=dev, **zoo)
    gen = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randint(0, 256, (batch, 640, 640, 3), generator=gen, device=dev,
                           dtype=torch.uint8)
    h, w = int(frames.shape[1]), int(frames.shape[2])
    conf = cfg.benchmark_conf

    stages = {}
    with torch.inference_mode():
        e2e = cuda_ms_windows(lambda: pipe.run_fused(frames), ITERS, E2E_WINDOWS)
        stem_name = "letterbox, x 1/255" if zoo else "stem (K3)"
        stages[stem_name] = cuda_ms(lambda: pipe._stem(frames), ITERS)
        stem = pipe._stem(frames)
        stages["detector_body"] = cuda_ms(lambda: pipe._detect(stem), ITERS)
        head = pipe._detect(stem)
        stages["decode_topk"] = cuda_ms(lambda: pipe._candidates(head), ITERS)
        cands = pipe._candidates(head)
        stages["nms_budget"] = cuda_ms(lambda: pipe._suppress(*cands, conf), ITERS)
        bx, s, _, v = pipe._suppress(*cands, conf)
        stages["unmap_area"] = cuda_ms(lambda: pipe._unmap(bx, v, h, w), ITERS)
        orig, v = pipe._unmap(bx, v, h, w)
        stages["roi_crop"] = cuda_ms(lambda: pipe._crop(frames, orig, v), ITERS)
        crops = pipe._crop(frames, orig, v)
        stages["classifier_budgeted"] = cuda_ms(
            lambda: pipe._classify_budgeted(crops, s, v), ITERS
        )

        pipe.run_fused(frames)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(TRACED):
                pipe.run_fused(frames)
            end.record()
            torch.cuda.synchronize()
        traced_ms = start.elapsed_time(end) / TRACED

    # device-side events: kernels, memcpys and memsets, one stream, so their
    # durations add up to the busy time
    by_kind, by_name, n_events, n_syncs = {}, {}, 0, 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            n_syncs += "StreamSynchronize" in ev.name
        else:
            ms = ev.time_range.elapsed_us() / 1e3 / TRACED
            k = kind_of(ev.name)
            by_kind[k] = by_kind.get(k, 0.0) + ms
            t, c = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (t + ms, c + 1)
            n_events += 1
    busy_ms = sum(by_kind.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    e2e_sorted = sorted(e2e)
    return {
        "detector": detector,
        "classifier": classifier,
        "batch": batch,
        "dtype": str(DTYPE).removeprefix("torch."),
        "e2e_ms_per_batch_windows": e2e,
        "e2e_ms_per_batch": e2e_sorted[len(e2e) // 2],
        "fps": batch / e2e_sorted[len(e2e) // 2] * 1e3,
        "stage_ms": stages,
        "stage_sum_ms": sum(stages.values()),
        "profiled": {
            "traced_ms_per_batch": traced_ms,
            "device_ms_per_batch": busy_ms,
            "idle_share": 1 - busy_ms / traced_ms,
            "device_events_per_batch": n_events / TRACED,
            "stream_syncs_per_batch": n_syncs / TRACED,
            "device_ms_by_kind": by_kind,
            "top_kernels": [
                {"name": name[:100], "ms_per_batch": t, "calls_per_batch": c / TRACED}
                for name, (t, c) in top
            ],
        },
        "config": dataclasses.asdict(cfg)["nms"] | {
            "crop_det_budget": cfg.crop_det_budget,
            "cls_crop_budget": cfg.cls_crop_budget,
        },
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--detector", default="yolo_plus_v2",
                        choices=["yolo_plus_v2", "yolov11n", "yolov5n", "yolov5n_legacy"])
    parser.add_argument("--classifier", default="shufflenetv2",
                        choices=["shufflenetv2", "resnet18", "mobilenetv2", "efficientnet"])
    parser.add_argument("--batch", type=int, default=BATCH)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("stage_split: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    result = measure(torch.device("cuda", 0), args.detector, args.classifier, args.batch)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(json.dumps({"device": smi, **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
