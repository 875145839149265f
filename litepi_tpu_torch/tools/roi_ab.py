"""Device time of the ROI crop kernel (``csrc/roi.cu``) beside other
versions of its source, at the three shapes the main path gives it.

    python -m litepi_tpu_torch.tools.roi_ab OTHER/roi.cu [OTHER2/roi.cu ...]

Each other source is built with this checkout's ``nvcc`` flags and called
through this checkout's wrapper (``kernels/roi.py``), so it must export the
same C entry point ``litepi_roi_crop``.  The shapes, on the inputs
``chip_smoke.py`` checks (:func:`roi_inputs`, seed 1): B=128 D=8 640x640
dense (the serving crop), B=8 D=8 1080x1920 dense, and B=8 D=8 1080x1920
pyramid on levels built in advance; 64x64 crops.  The versions take turns,
the others, this one, this one, the others in reverse, and each reading is
the mean kernel duration from ``torch.profiler`` over 100 launches
(``timing.kernel_device_ms``), beside the bound: the bytes the crop
must move over the H100 SXM's 3.35 TB/s.  Prints one JSON line, with each
version's largest difference from this one's output; exits non-zero when
one is over 1e-3 (the tolerance ``chip_smoke.py`` holds K2 to) or
without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from litepi_tpu_torch.kernels import build as kbuild
from litepi_tpu_torch.kernels.roi import roi_crop_cuda
from litepi_tpu_torch.ops.roi import (
    EXACT_EXTENT,
    axis_taps,
    build_pyramid,
    pyramid_scales,
    roi_geometry,
)
from litepi_tpu_torch.tools.timing import kernel_device_ms

SIZES = ((128, 8, 640, 640), (8, 8, 1080, 1920))  # B, D, H, W
CASES = ((0, "dense"), (1, "dense"), (1, "pyramid"))  # (size, mode)
OUT_SIZE = 64
ITERS = 100
TOL = 1e-3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published, as in chip_smoke.py


def roi_inputs(gen, b: int, d: int, h: int, w: int, dev):
    """Random uint8 frames (B, H, W, 3), boxes (B, D, 4) with extents from
    sub-pixel to several hundred pixels (above EXACT_EXTENT), 90% valid."""
    frames = torch.randint(0, 256, (b, h, w, 3), generator=gen, device=dev, dtype=torch.uint8)
    x1 = torch.rand((b, d), generator=gen, device=dev) * w * 0.9
    y1 = torch.rand((b, d), generator=gen, device=dev) * h * 0.9
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


def build_other(source: Path) -> ctypes.CDLL:
    """``source`` compiled as ``kernels/build.py`` compiles ``csrc/roi.cu``."""
    key = hashlib.sha256(source.read_bytes() + " ".join(kbuild.NVCC_FLAGS).encode())
    lib = kbuild.BUILD_DIR / f"libroi_ab-{key.hexdigest()[:16]}.so"
    if not lib.exists():
        kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o", str(lib), str(source)],
                       check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def measure(dev, others) -> dict:
    libs = {"this": kbuild.load("roi")}
    libs.update((str(p), build_other(Path(p))) for p in others)
    gen = torch.Generator(device=dev).manual_seed(1)
    inputs = [roi_inputs(gen, *size, dev) for size in SIZES]
    cases = []
    for size, mode in CASES:
        frames, boxes, valid = inputs[size]
        h, w = int(frames.shape[1]), int(frames.shape[2])
        levels = [frames] if mode == "dense" else build_pyramid(frames, len(pyramid_scales(h, w)))
        cases.append((levels, boxes, valid, mode))

    def crop(case):
        levels, boxes, valid, mode = case
        return roi_crop_cuda(levels, boxes, valid, OUT_SIZE, EXACT_EXTENT, mode)

    def bound_ms(case):
        # source bytes the taps touch, boxes and valid read, crops written;
        # its ~9 operations per value are far below the bytes' time
        levels, boxes, valid, _ = case
        n = touched_bytes(levels, boxes, valid, OUT_SIZE) + boxes.numel() * 4 + valid.numel()
        n += boxes.shape[0] * boxes.shape[1] * OUT_SIZE * OUT_SIZE * levels[0].shape[-1] * 4
        return n / HBM_BYTES_PER_S * 1e3

    order = [*others, "this", "this", *reversed(others)]
    readings = {name: [[] for _ in CASES] for name in libs}
    try:
        for name in order:
            kbuild._loaded["roi"] = libs[name]  # the wrapper's library
            for i, case in enumerate(cases):
                ms, seen = kernel_device_ms(lambda: crop(case), ITERS, "roi_crop_kernel")
                if seen < ITERS // 2:
                    raise RuntimeError(f"{name}: the trace shows {seen} of {ITERS} launches")
                readings[name][i].append(ms)
        outs = {}
        for name, lib in libs.items():
            kbuild._loaded["roi"] = lib
            outs[name] = [crop(case) for case in cases]
    finally:
        kbuild._loaded["roi"] = libs["this"]
    return {
        "cases": [
            {"shape": "B={} D={} {}x{} out={}".format(*SIZES[size], OUT_SIZE), "mode": mode,
             "bound_ms": bound_ms(cases[i]),
             "device_ms": {name: r[i] for name, r in readings.items()},
             "max_abs_diff": {name: float((got[i] - outs["this"][i]).abs().max())
                              for name, got in outs.items()}}
            for i, (size, mode) in enumerate(CASES)
        ],
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("others", nargs="+", help="other versions of csrc/roi.cu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("roi_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    result = measure(dev, args.others)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(json.dumps({"device": smi, **result}))
    worst = max(d for case in result["cases"] for d in case["max_abs_diff"].values())
    return 0 if worst <= TOL else 1


if __name__ == "__main__":
    sys.exit(main())
