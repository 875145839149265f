"""Timing on the card: mean milliseconds per call from CUDA events, and
the device time of named kernels from ``torch.profiler``, for the A/B
tools beside this module and ``chip_smoke.py``.
"""

from __future__ import annotations

import torch


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
