"""Device time of the device letterbox (``ops/letterbox.py::letterbox_nchw``)
beside other versions of that module, at the frames of the main path's B=8
runs.

    python -m litepi_tpu_torch.tools.letterbox_ab OTHER/letterbox.py [OTHER2/letterbox.py ...]

Each other version is loaded from its file and must define
``letterbox_nchw(images, new_shape, dtype)``.  The case: B=8 random uint8
1080x1920 frames on the card (seed 1) to a 640 canvas, in bfloat16 (what
the bf16 serving pipeline calls) and in float32.  The versions take turns,
the others, this one, this one, the others in reverse, and each reading is
the device time per call summed over every kernel the call launches, from
``torch.profiler`` over 50 calls (``timing.kernel_device_times``),
beside the bound: the frames read once and the canvas written once over the
H100 SXM's 3.35 TB/s.  Prints one JSON line with each version's largest
difference from this one's canvas; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys

import torch

from litepi_tpu_torch.ops import letterbox as this_module
from litepi_tpu_torch.tools.timing import kernel_device_times

BATCH, HEIGHT, WIDTH, CANVAS = 8, 1080, 1920, 640
DTYPES = (torch.bfloat16, torch.float32)
ITERS = 50
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published, as in chip_smoke.py


def load(path: str, i: int):
    """The module at ``path`` under a name of its own."""
    spec = importlib.util.spec_from_file_location(f"letterbox_ab_other_{i}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def device_ms_per_call(fn, iters: int) -> tuple:
    """(device milliseconds per call summed over all of the call's kernels,
    launches seen per call) from one traced window."""
    times = kernel_device_times(fn, iters, "")
    total = sum(ms * n for ms, n in times.values())
    return total / iters, sum(n for _, n in times.values()) / iters


def measure(dev, others) -> dict:
    modules = {"this": this_module}
    modules.update((p, load(p, i)) for i, p in enumerate(others))
    gen = torch.Generator(device=dev).manual_seed(1)
    frames = torch.randint(0, 256, (BATCH, HEIGHT, WIDTH, 3), generator=gen, device=dev,
                           dtype=torch.uint8)
    order = [*others, "this", "this", *reversed(others)]
    cases = []
    for dtype in DTYPES:
        readings = {name: [] for name in modules}
        launches = {}
        for name in order:
            call = lambda: modules[name].letterbox_nchw(frames, CANVAS, dtype)  # noqa: E731
            ms, per_call = device_ms_per_call(call, ITERS)
            readings[name].append(ms)
            launches[name] = per_call
        outs = {name: m.letterbox_nchw(frames, CANVAS, dtype).float() for name, m in modules.items()}
        n_bytes = frames.numel() + BATCH * 3 * CANVAS * CANVAS * torch.finfo(dtype).bits // 8
        cases.append({
            "shape": f"B={BATCH} {HEIGHT}x{WIDTH} -> {CANVAS}x{CANVAS}", "dtype": str(dtype),
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "device_ms": readings, "kernels_per_call": launches,
            "max_abs_diff": {name: float((o - outs["this"]).abs().max()) for name, o in outs.items()},
        })
    return {"cases": cases}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("others", nargs="+", help="other versions of ops/letterbox.py")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("letterbox_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    result = measure(dev, args.others)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(json.dumps({"device": smi, **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
