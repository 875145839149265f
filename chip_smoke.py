"""Drive the port's main path on one CUDA card and hold its kernels against
their plain versions.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``litepi_tpu_torch/csrc`` (one ``nvcc`` per
source, in parallel), then:

1. NMS kernel vs ``suppress_sorted`` on the same CUDA tensors: keep masks
   bit-equal at B=128 with K=64 (the serving candidate budget) and K=512;
2. ROI crop kernel vs ``crop_and_resize_plain``, both modes on B=128, D=8,
   640x640 (the serving crop) and on B=8, D=8, 1080x1920 (three pyramid
   levels); dense timed on the first, pyramid on the second, both alone
   and, for pyramid, with the level build the main path runs; tolerance
   1e-3 on 0-255 values (both round each f32 product and sum once, in the
   same order; 0 is expected);
3. the small pipeline (narrow detector, 10-class classifier, float32, TF32
   off) on the card vs the same pipeline on the CPU, where the kernels'
   plain versions run;
4. the main path: ``TwoStagePipeline.run_fused`` at the full width of
   yolo_plus_v2 + ShuffleNetV2-91 in bfloat16 with the serving
   configuration (64 candidates, 16 detections, crop_det_budget 8,
   cls_crop_budget 4*B, BGR frames): B=128 at 640x640 and B=8 at
   1080x1920, then B=8 at 1080x1920 with the pyramid crop.  Launch counts
   are zeroed just before and read just after; every kernel must have run.

Prints the build's resource report, the card's ``nvidia-smi`` name and power
limit, a ``{"kernels": [...]}`` JSON line (times from CUDA events after
warm-up, the median of 5 windows; ``host_ms`` the host's time to issue one
call; bounds from this run's inputs against the H100 SXM's published
3.35 TB/s and 67 TFLOP/s float32), an ``{"e2e": ...}`` JSON line, and last
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

from litepi_tpu_torch.core.types import DetectorConfig, NMSConfig, PipelineConfig
from litepi_tpu_torch.kernels import build as kbuild
from litepi_tpu_torch.kernels import launch_counts, reset_launch_counts
from litepi_tpu_torch.kernels.nms import nms_suppress_cuda
from litepi_tpu_torch.kernels.roi import roi_crop_cuda
from litepi_tpu_torch.ops.nms import suppress_sorted
from litepi_tpu_torch.ops.roi import (
    EXACT_EXTENT,
    axis_taps,
    build_pyramid,
    crop_and_resize_plain,
    crop_and_resize_pyramid,
    pyramid_scales,
    roi_geometry,
)
from litepi_tpu_torch.pipeline import TwoStagePipeline
from litepi_tpu_torch.tools.stage_split import cuda_ms, cuda_ms_windows

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores, published
ROI_TOL = 1e-3

NMS_BATCH, NMS_KS = 128, (64, 512)  # serving K, and the NMSConfig default
ROI_DENSE = (128, 8, 640, 640)  # B, D, H, W of the serving crop
ROI_PYRAMID = (8, 8, 1080, 1920)
MAIN_RUNS = ((128, 640, 640, "dense"), (8, 1080, 1920, "dense"),
             (8, 1080, 1920, "pallas"))
WINDOWS = 5  # back-to-back timing windows per kernel and per e2e run; the
# median is reported, every window is printed

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


def build_kernels() -> None:
    t0 = time.perf_counter()
    paths = kbuild.build()
    print(f"built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name, path in sorted(paths.items()):
        log = (path.parent / (path.name + ".log"))
        for line in log.read_text().splitlines() if log.exists() else []:
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


# --------------------------------------------------------------------- #
# NMS kernel                                                            #
# --------------------------------------------------------------------- #

def nms_inputs(gen, b: int, k: int, dev):
    xy = torch.rand((b, k, 2), generator=gen, device=dev) * 500
    wh = 8 + torch.rand((b, k, 2), generator=gen, device=dev) * 200
    boxes = torch.cat([xy, xy + wh], -1).contiguous()
    cls = torch.randint(0, 3, (b, k), generator=gen, device=dev, dtype=torch.int32)
    n_valid = torch.randint(k // 2, k + 1, (b, 1), generator=gen, device=dev)
    valid = torch.arange(k, device=dev)[None, :] < n_valid
    return boxes, cls, valid.contiguous()


def check_nms(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    b, thr = NMS_BATCH, 0.45
    result = {}
    for k in NMS_KS:
        boxes, cls, valid = nms_inputs(gen, b, k, dev)
        got = nms_suppress_cuda(boxes, cls, valid, thr)
        want = suppress_sorted(boxes, valid, cls, thr)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        if mismatches:
            fail(f"NMS kernel K={k}: {mismatches} keep bits differ from the plain version")
        if not (0 < int(got.sum()) < int(valid.sum())):
            fail(f"NMS check K={k}: inputs suppress nothing or keep nothing")
        ms, windows = median_ms(lambda: nms_suppress_cuda(boxes, cls, valid, thr), 200)
        plain_ms = cuda_ms(lambda: suppress_sorted(boxes, valid, cls, thr), 10, 1)
        n_bytes = b * k * (16 + 4 + 1) + b * k  # boxes, cls, valid in; keep out
        # one class compare per pair j < i, an IoU (~14 operations) only for
        # the same-class pairs, 5 per box for the areas
        pairs = torch.ones(k, k, dtype=torch.bool, device=dev).triu(1)
        same = int(((cls[:, :, None] == cls[:, None, :]) & pairs).sum())
        n_flops = b * k * (k - 1) / 2 + 14 * same + 5 * b * k
        host = host_ms(lambda: nms_suppress_cuda(boxes, cls, valid, thr), 200)
        result[k] = dict(mismatches=mismatches, ms=ms, windows=windows, host_ms=host,
                         plain_ms=plain_ms, bound=bound(n_bytes, n_flops))
        print(f"nms K={k}: bit-equal, kernel {ms:.4f} ms (windows {windows}), "
              f"host issue {host:.4f} ms, plain {plain_ms:.3f} ms")
    return result


# --------------------------------------------------------------------- #
# ROI crop kernel                                                       #
# --------------------------------------------------------------------- #

def roi_inputs(gen, b: int, d: int, h: int, w: int, dev):
    frames = torch.randint(0, 256, (b, h, w, 3), generator=gen, device=dev, dtype=torch.uint8)
    x1 = torch.rand((b, d), generator=gen, device=dev) * w * 0.9
    y1 = torch.rand((b, d), generator=gen, device=dev) * h * 0.9
    # extents from sub-pixel to several hundred pixels (above EXACT_EXTENT)
    ext = torch.exp(torch.rand((b, d, 2), generator=gen, device=dev) * 6.5) - 0.5
    boxes = torch.stack(
        [x1, y1, (x1 + ext[..., 0]).clamp(max=w), (y1 + ext[..., 1]).clamp(max=h)], -1
    ).contiguous()
    valid = torch.rand((b, d), generator=gen, device=dev) < 0.9
    return frames, boxes, valid


def touched_bytes(levels, boxes, valid, out_size: int) -> int:
    """Source bytes the 2-tap crop must read for this run's boxes: per valid
    ROI, the distinct rows times the distinct columns its taps touch."""
    hw = [(int(l.shape[1]), int(l.shape[2])) for l in levels]
    _, ys, ye, xs, xe, yl, xl = roi_geometry(boxes, hw, EXACT_EXTENT)

    def distinct(start, extent, limit):
        i0, i1, _, _ = axis_taps(start, extent, limit, out_size)
        taps = torch.cat([i0, i1], -1).sort(-1).values
        return 1 + (taps[..., 1:] != taps[..., :-1]).sum(-1)

    rows, cols = distinct(ys, ye, yl), distinct(xs, xe, xl)
    return int((rows * cols * valid).sum()) * int(levels[0].shape[-1])


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
    kernel = lambda: roi_crop_cuda([frames], boxes, valid, s, EXACT_EXTENT, "dense")  # noqa: E731
    ms, windows = median_ms(kernel, 100)
    host = host_ms(kernel, 100)
    plain_ms = cuda_ms(lambda: crop_and_resize_plain([frames], boxes, valid, s), 10, 1)
    x = frames.permute(0, 3, 1, 2).float().contiguous()
    grid = grid_for(boxes, h, w, s)
    lib = lambda: F.grid_sample(  # noqa: E731
        x, grid, mode="bilinear", padding_mode="border", align_corners=False
    )
    lib_out = lib().reshape(b, 3, d, s, s).permute(0, 2, 3, 4, 1)
    lib_err = float(((lib_out - got).abs() * valid[..., None, None, None]).max())
    library_ms = cuda_ms(lib, 20)
    n_out = got.numel()
    n_valid_out = int(valid.sum()) * s * s * 3
    n_bytes = touched_bytes([frames], boxes, valid, s) + boxes.numel() * 4 + valid.numel() + n_out * 4
    result["dense"] = dict(err=err, ms=ms, windows=windows, host_ms=host, plain_ms=plain_ms,
                           library_ms=library_ms, library_err=lib_err,
                           bound=bound(n_bytes, 9 * n_valid_out))
    print(f"roi dense: max err {err}, kernel {ms:.4f} ms (windows {windows}), "
          f"host issue {host:.4f} ms, plain {plain_ms:.3f} ms, "
          f"grid_sample {library_ms:.4f} ms (max diff {lib_err:.3g})")
    del x, grid, lib_out

    # pyramid mode at 1080x1920: levels 1/4, 1/16 and 1/64 (dense mode
    # checked on the same inputs)
    b, d, h, w = ROI_PYRAMID
    frames, boxes, valid = roi_inputs(gen, b, d, h, w, dev)
    result["dense"]["err"] = max(
        result["dense"]["err"], roi_error(frames, boxes, valid, s, "dense")[0]
    )
    err, got, levels = roi_error(frames, boxes, valid, s, "pyramid")
    err = max(err, err_pyr_640)
    # the kernel alone on levels built once, and the entry the main path
    # calls (plain-PyTorch level build + kernel)
    kernel = lambda: roi_crop_cuda(levels, boxes, valid, s, EXACT_EXTENT, "pyramid")  # noqa: E731
    ms, windows = median_ms(kernel, 100)
    host = host_ms(kernel, 100)
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
    result["pyramid"] = dict(err=err, ms=ms, windows=windows, host_ms=host, plain_ms=plain_ms,
                             levels=len(levels), bound=bound(n_bytes, 9 * n_valid_out),
                             with_levels_ms=with_levels_ms,
                             with_levels_windows=with_levels_windows,
                             with_levels_bound=with_levels_bound)
    print(f"roi pyramid ({len(levels)} levels): max err {err}, kernel {ms:.4f} ms "
          f"(windows {windows}), host issue {host:.4f} ms, plain {plain_ms:.3f} ms, levels+kernel "
          f"{with_levels_ms:.4f} ms (windows {with_levels_windows})")
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
        _, scores, _ = pipe._candidates(pipe._detect(pipe._letterbox(f)))
    return scores.cpu()


def check_small_pipeline(dev):
    """The float32 small pipeline on the card vs on the CPU, frame by frame.

    Each frame gets a conf threshold in a gap of its candidate scores wider
    than 20x the card-vs-CPU score difference, so that both runs take the
    same discrete decisions; then valid, class ids and labels must agree
    exactly, boxes within 1e-2 px, scores 1e-5, probabilities 1e-4.
    """
    gpu = TwoStagePipeline.initialize(SMALL, seed=3, device=dev)
    cpu = TwoStagePipeline.initialize(SMALL, seed=3, device="cpu")
    frames = peaked_frames()
    n_valid = 0
    for i in range(frames.shape[0]):
        f = frames[i : i + 1]
        s_cpu, s_gpu = candidate_scores(cpu, f)[0], candidate_scores(gpu, f)[0]
        noise = float((s_cpu - s_gpu).abs().max())
        gaps = s_cpu[:-1] - s_cpu[1:]
        ok = [j for j in range(1, 9) if bool((gaps[:j] > 20 * noise + 1e-7).all())]
        if not ok:
            fail(f"small pipeline frame {i}: no well-separated conf threshold")
        j = ok[-1]
        conf = float((s_cpu[j - 1] + s_cpu[j]) / 2)
        got = {k: v.cpu() for k, v in gpu.run_fused(f, conf).items()}
        want = cpu.run_fused(f, conf)
        for k in ("valid", "det_class_ids"):
            if not torch.equal(got[k], want[k]):
                fail(f"small pipeline frame {i}: {k} differs card vs CPU")
        for k, tol in (("boxes", 1e-2), ("det_scores", 1e-5)):
            err = float((got[k] - want[k]).abs().max())
            if not err <= tol:
                fail(f"small pipeline frame {i}: {k} differs by {err} > {tol}")
        # crops compare where both truncated the box to the same pixels (a
        # coordinate within float noise of an integer may floor either way)
        same = (got["boxes"].floor() == want["boxes"].floor()).all(-1)
        for k in ("cls_probs", "cls_scores"):
            err = float((got[k] - want[k]).abs()[same].max())
            if not err <= 1e-4:
                fail(f"small pipeline frame {i}: {k} differs by {err} > 1e-4")
        p = want["cls_probs"].sort(-1, descending=True).values
        clear = same & ((p[..., 0] - p[..., 1]) > 1e-5)
        if not torch.equal(got["cls_labels"][clear], want["cls_labels"][clear]):
            fail(f"small pipeline frame {i}: cls_labels differ card vs CPU")
        n_valid += int(want["valid"].sum())
        print(f"small pipeline frame {i}: card == CPU (conf {conf:.8f}, "
              f"{j} candidates over it, score noise {noise:.3g})")
    if n_valid == 0:
        fail("small pipeline: no valid detection to compare")


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


def main_path(dev):
    """Full width, bf16, serving config; returns launch counts and timings."""
    gen = torch.Generator(device=dev).manual_seed(2)
    runs = []
    for b, h, w, roi_impl in MAIN_RUNS:
        cfg = dataclasses.replace(SERVING, cls_crop_budget=4 * b, roi_impl=roi_impl)
        t0 = time.perf_counter()
        pipe = TwoStagePipeline.initialize(cfg, seed=0, dtype=torch.bfloat16, device=dev)
        frames = torch.randint(0, 256, (b, h, w, 3), generator=gen, device=dev, dtype=torch.uint8)
        pipe.run_fused(frames)  # warm-up (cuDNN algorithm selection)
        torch.cuda.synchronize()
        print(f"pipeline b={b} {h}x{w} {roi_impl}: init + first run "
              f"{time.perf_counter() - t0:.1f} s")
        runs.append((pipe, frames, b, h, w, roi_impl))

    reset_launch_counts()
    outs = [pipe.run_fused(frames) for pipe, frames, *_ in runs]
    torch.cuda.synchronize()
    counts = launch_counts()
    for out, (pipe, _, b, h, w, roi_impl) in zip(outs, runs):
        check_outputs(out, b, pipe.cfg.crop_det_budget, h, w,
                      pipe.cfg.num_classifier_classes, f"run_fused b={b} {h}x{w} {roi_impl}")
    for name, n in counts.items():
        if n < 1:
            fail(f"kernel {name} was not launched on the main path")
    print(f"main path launch counts: {counts}")

    timings = []
    for pipe, frames, b, h, w, roi_impl in runs:
        ms, windows = median_ms(lambda: pipe.run_fused(frames), 20, 2)
        timings.append(dict(batch=b, frame=f"{h}x{w}", roi_impl=roi_impl,
                            ms_per_batch=ms, fps=b / ms * 1e3, windows_ms=windows))
        print(f"run_fused b={b} {h}x{w} {roi_impl}: {ms:.3f} ms/batch, "
              f"{b / ms * 1e3:.1f} FPS (windows {windows})")
    return counts, timings


def run(dev) -> None:
    """Every phase on ``dev``; prints the kernels and e2e JSON lines and the
    card's name and power limit.  Raises on any failure."""
    smi = nvidia_smi()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    build_kernels()

    nms = check_nms(dev)
    roi = check_roi(dev)
    check_small_pipeline(dev)
    counts, timings = main_path(dev)

    k0, k1 = NMS_KS
    dense, pyr = roi["dense"], roi["pyramid"]
    kernels = [
        dict(name="nms_suppress", route="cuda", source="litepi_tpu_torch/csrc/nms.cu",
             replaces="litepi_tpu/ops/pallas_nms.py:98", launches=counts["nms_suppress"],
             max_abs_err=float(nms[k0]["mismatches"]), ms=nms[k0]["ms"],
             plain_ms=nms[k0]["plain_ms"], bound_ms=nms[k0]["bound"][0],
             bound_by=nms[k0]["bound"][1], library_ms=None, host_ms=nms[k0]["host_ms"],
             shape=f"B={NMS_BATCH} K={k0}", **{
                 f"k{k1}_ms": nms[k1]["ms"], f"k{k1}_plain_ms": nms[k1]["plain_ms"],
                 f"k{k1}_bound_ms": nms[k1]["bound"][0]}),
        dict(name="roi_crop_dense", route="cuda", source="litepi_tpu_torch/csrc/roi.cu",
             replaces="litepi_tpu/ops/pallas_roi.py:207", launches=counts["roi_crop_dense"],
             max_abs_err=dense["err"], ms=dense["ms"], plain_ms=dense["plain_ms"],
             bound_ms=dense["bound"][0], bound_by=dense["bound"][1],
             library_ms=dense["library_ms"], host_ms=dense["host_ms"],
             library="F.grid_sample(border, align_corners=False)",
             library_max_abs_diff=dense["library_err"],
             shape="B={} D={} {}x{} out=64".format(*ROI_DENSE)),
        dict(name="roi_crop_pyramid", route="cuda", source="litepi_tpu_torch/csrc/roi.cu",
             replaces="litepi_tpu/ops/pallas_roi.py:207", launches=counts["roi_crop_pyramid"],
             max_abs_err=pyr["err"], ms=pyr["ms"], plain_ms=pyr["plain_ms"],
             bound_ms=pyr["bound"][0], bound_by=pyr["bound"][1], library_ms=None,
             host_ms=pyr["host_ms"],
             with_levels_ms=pyr["with_levels_ms"],
             with_levels_bound_ms=pyr["with_levels_bound"][0],
             shape="B={} D={} {}x{} out=64".format(*ROI_PYRAMID)
             + f", {pyr['levels']} levels built in advance"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"e2e": timings, "power": smi}))
    print(smi)


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
