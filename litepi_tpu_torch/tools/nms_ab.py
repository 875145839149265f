"""Device time of the NMS kernel (``csrc/nms.cu``) beside other versions of
its source, at the candidate budgets the main path gives it.

    python -m litepi_tpu_torch.tools.nms_ab OTHER/nms.cu [OTHER2/nms.cu ...]

e.g. the parent commit's source beside this one's:

    git show HEAD~1:litepi_tpu_torch/csrc/nms.cu > build/nms_parent.cu
    python -m litepi_tpu_torch.tools.nms_ab build/nms_parent.cu

Each other source is built with this checkout's ``nvcc`` flags.  One that
exports ``litepi_nms_scratch_bytes`` (two kernels above K = 64) is called
through its own entry point with a scratch buffer of its own size; one that
does not, with the single-kernel entry point of the first design,
``litepi_nms_suppress(boxes, cls, valid, keep, B, K, thr, stream)``.  This
checkout's source is called through its wrapper (``kernels/nms.py``).  The
cases (:data:`CASES`), on ``chip_smoke.py``'s NMS inputs
(:func:`nms_inputs`, seed 0) with 1 class (the serving detector's): B=128
at K=64 (the serving budget) and K=512 (``NMSConfig``'s default, the
staged ``detect``); B=8 at K=256 (the stream app's budget), 768 (where
the two greedy passes tie at B=8), 1,024 (the Faster R-CNN RPN's default
budget), 2,000 (its ``--pre_nms_topk 2000``) and 8,400 (the e2e CLI's
``--max_candidates 8400``); B=128 at K=2,048 (a timing shape).  The
versions take turns, the others, this one, this one, the others in
reverse, and each reading is the device time per call from
``torch.profiler`` over 200 calls (the sum over the call's kernels, and
each kernel apart: the mask kernel and the greedy pass;
``timing.kernel_device_times``).  Prints one JSON line with every
version's keep masks compared with this one's and this one's greedy route
and cluster shape per case; exits non-zero when one differs in any bit, or
without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from litepi_tpu_torch.kernels import build as kbuild
from litepi_tpu_torch.kernels.nms import cluster_shape, greedy_route, nms_suppress_cuda
from litepi_tpu_torch.tools.timing import kernel_device_times

CASES = ((128, 64), (128, 512), (8, 256), (8, 768), (8, 1024), (8, 2000), (8, 8400),
         (128, 2048))  # (B, K)
THR = 0.45
ITERS = 200


def nms_inputs(gen, b: int, k: int, num_classes: int, dev):
    """Score-ordered candidates: boxes (B, K, 4) with corners in [0, 500)
    and sides 8..208 px, class ids below ``num_classes``, and the first
    K/2..K of each image valid."""
    xy = torch.rand((b, k, 2), generator=gen, device=dev) * 500
    wh = 8 + torch.rand((b, k, 2), generator=gen, device=dev) * 200
    boxes = torch.cat([xy, xy + wh], -1).contiguous()
    cls = torch.randint(0, num_classes, (b, k), generator=gen, device=dev, dtype=torch.int32)
    n_valid = torch.randint(k // 2, k + 1, (b, 1), generator=gen, device=dev)
    valid = torch.arange(k, device=dev)[None, :] < n_valid
    return boxes, cls, valid.contiguous()


def build_other(source: Path) -> ctypes.CDLL:
    """``source`` compiled as ``kernels/build.py`` compiles ``csrc/nms.cu``."""
    key = hashlib.sha256(source.read_bytes() + " ".join(kbuild.NVCC_FLAGS).encode())
    lib = kbuild.BUILD_DIR / f"libnms_ab-{key.hexdigest()[:16]}.so"
    if not lib.exists():
        kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o", str(lib), str(source)],
                       check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def caller(lib: ctypes.CDLL):
    """fn(boxes, cls, valid) -> keep through ``lib``'s own entry point."""
    fn = lib.litepi_nms_suppress
    two_kernels = hasattr(lib, "litepi_nms_scratch_bytes")
    fn.argtypes = [ctypes.c_void_p] * (5 if two_kernels else 4) + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if two_kernels:
        lib.litepi_nms_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.litepi_nms_scratch_bytes.restype = ctypes.c_size_t

    def call(boxes, cls, valid):
        b, k = valid.shape
        keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
        ptrs = [boxes.data_ptr(), cls.data_ptr(), valid.data_ptr(), keep.data_ptr()]
        if two_kernels:
            n = lib.litepi_nms_scratch_bytes(b, k)
            scratch = torch.empty(n, dtype=torch.uint8, device=boxes.device) if n else None
            ptrs.append(None if scratch is None else scratch.data_ptr())
        kbuild.check(fn(*ptrs, b, k, THR, torch.cuda.current_stream().cuda_stream),
                     "nms_ab launch")
        return keep
    return call


def measure(dev, others) -> dict:
    calls = {"this": lambda boxes, cls, valid: nms_suppress_cuda(boxes, cls, valid, THR)}
    calls.update((str(p), caller(build_other(Path(p)))) for p in others)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [nms_inputs(gen, b, k, 1, dev) for b, k in CASES]
    order = [*others, "this", "this", *reversed(others)]
    readings = {name: [[] for _ in CASES] for name in calls}
    split = {name: [{} for _ in CASES] for name in calls}
    for name in order:
        for i, case in enumerate(cases):
            for _ in range(3):  # the trace now and then drops most of a window's kernels
                times = kernel_device_times(lambda: calls[name](*case), ITERS, "nms_")
                seen = min((n for _, n in times.values()), default=0)
                if seen >= ITERS // 2:
                    break
            else:
                raise RuntimeError(f"{name} at {CASES[i]}: the trace shows {seen} of {ITERS} "
                                   "calls, three times")
            readings[name][i].append(sum(ms for ms, _ in times.values()))
            for kernel, (ms, _) in times.items():
                short = re.search(r"nms_\w+", kernel).group(0)
                split[name][i].setdefault(short, []).append(ms)
    outs = {name: [call(*case) for case in cases] for name, call in calls.items()}
    return {
        "cases": [
            {"shape": f"B={b} K={k}, 1 class", "greedy_route": greedy_route(b, k),
             "cluster_blocks_and_capacity": cluster_shape(b, k),
             "device_ms": {n: r[i] for n, r in readings.items()},
             "device_ms_by_kernel": {n: s[i] for n, s in split.items()},
             "differing_bits": {n: int((got[i] != outs["this"][i]).sum())
                                for n, got in outs.items()}}
            for i, (b, k) in enumerate(CASES)
        ],
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("others", nargs="+", help="other versions of csrc/nms.cu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("nms_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    result = measure(torch.device("cuda", 0), args.others)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(json.dumps({"device": smi, **result}))
    worst = max(d for case in result["cases"] for d in case["differing_bits"].values())
    return 0 if worst == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
