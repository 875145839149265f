"""One run of one cell: set up, warm up, measure for ``--seconds``, judge
the outputs, print one result line.

    python3 -m cardbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the raw weights and the frames from the seed on the card,
builds the program through its public constructor and warms up the cell's
own shapes.  The window then drives the program's entry (``run_fused``)
with the cell's traffic, closed loop; each batch's outputs go to pinned
host memory behind an event, and a thread takes the time each batch's
outputs reach the host.  With ``--trace 1`` the window is split: an
untraced part (host clocks: the rate) and a profiled tail
(``torch.profiler``: device time, idle gaps); the per-layer metrics'
readers (``metrics/<name>.py``) take their numbers from what both parts
collected.  After the window the program is freed and the plain reference
judges the kept outputs (``cardbench/judge.py``) against the cell's limits
(``limits/<cell>.json``).

The last line of standard output is the result; the numbers compared
with their limits are also the last lines of standard error.  Exits
non-zero, printing no result, without the card the cell asks for, or
when ``jax``, ``jaxlib``, ``flax`` or ``litepi_tpu`` were loaded.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import queue
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from cardbench import spec as specs

FORBIDDEN = ("jax", "jaxlib", "flax", "litepi_tpu")
FIELDS = ("boxes", "det_scores", "det_class_ids", "valid", "cls_probs", "cls_labels",
          "cls_scores")
DRAIN_S = 60.0  # how long after the window a batch may still complete


def process_start_perf() -> float:
    """``time.perf_counter()`` at the moment this process started."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - (time.clock_gettime(time.CLOCK_BOOTTIME) - started)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def pin_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed directory of the checkout."""
    base = root / "build" / "cardbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(base / "nv_compute")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


# --------------------------------------------------------------------- #
# batches in flight                                                     #
# --------------------------------------------------------------------- #

class Flight:
    """At most ``in_flight`` batches outstanding.  Each batch's outputs are
    copied to pinned host memory behind an event; a thread waits on the
    events in order and takes the time each batch's outputs reached the
    host, and keeps the last host outputs of the pool items ``keep``
    names."""

    def __init__(self, torch, device, in_flight: int, keep=()):
        self.torch, self.device = torch, device
        self.cuda = device.type == "cuda"
        self.slots = threading.Semaphore(in_flight)
        self.ring_size = in_flight + 1
        self.ring: List[Dict] = []
        self.keep = set(keep)
        self.kept: Dict[int, Dict] = {}
        self.done: Dict[int, float] = {}
        self.errors: List[BaseException] = []
        self.queue: "queue.Queue" = queue.Queue()
        self.thread = threading.Thread(target=self._complete, daemon=True)
        self.thread.start()

    def _buffers(self, k: int, out) -> Dict:
        if not self.ring:
            for _ in range(self.ring_size):
                self.ring.append({f: self.torch.empty(out[f].shape, dtype=out[f].dtype,
                                                      pin_memory=self.cuda) for f in FIELDS})
        return self.ring[k % self.ring_size]

    def acquire(self) -> None:
        self.slots.acquire()

    def submit(self, k: int, item: int, out) -> None:
        bufs = self._buffers(k, out)
        for f in FIELDS:
            bufs[f].copy_(out[f], non_blocking=self.cuda)
        event = None
        if self.cuda:
            event = self.torch.cuda.Event()
            event.record()
        self.queue.put((k, item, event, bufs))

    def _complete(self) -> None:
        while True:
            got = self.queue.get()
            if got is None:
                return
            k, item, event, bufs = got
            try:
                if event is not None:
                    event.synchronize()
                self.done[k] = time.perf_counter()
                if item in self.keep:
                    self.kept[item] = {f: bufs[f].numpy().copy() for f in FIELDS}
            except BaseException as e:  # reported by wait_all
                self.errors.append(e)
            finally:
                self.slots.release()

    def wait_all(self, n: int, timeout: float = DRAIN_S) -> None:
        """Wait until batches ``0 .. n-1`` completed or ``timeout`` passed."""
        deadline = time.perf_counter() + timeout
        while len(self.done) < n and time.perf_counter() < deadline and not self.errors:
            time.sleep(0.0005)
        if self.errors:
            raise self.errors[0]

    def close(self) -> None:
        self.queue.put(None)
        self.thread.join(timeout=DRAIN_S)


# --------------------------------------------------------------------- #
# the window's loops                                                    #
# --------------------------------------------------------------------- #

def closed_loop(call, pool, flight: Flight, n: int, record_function) -> dict:
    """``n`` batches back to back, round robin over ``pool``, at most
    ``in_flight`` outstanding.  Host times of the window."""
    done_before = len(flight.done)
    t_first = None
    for k in range(n):
        with record_function("cardbench.wait_slot"):
            flight.acquire()
        item = k % len(pool)
        t0 = time.perf_counter()
        t_first = t0 if t_first is None else t_first
        with record_function("cardbench.issue"):
            out = call(pool[item])
        with record_function("cardbench.readback"):
            flight.submit(done_before + k, item, out)
    flight.wait_all(done_before + n)
    done = [flight.done[done_before + k] for k in range(n) if done_before + k in flight.done]
    return {"t_first": t_first, "t_last": max(done) if done else float("nan"),
            "completed": len(done)}


# --------------------------------------------------------------------- #
# trace                                                                 #
# --------------------------------------------------------------------- #

def profiler(torch):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def trace_events(prof, torch, index: int):
    """(device intervals, host intervals, window (lo, hi) ns) of a profile
    whose window is the ``cardbench.window`` span; device intervals of the
    card ``index``."""
    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name, s = e.name(), e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            act = str(getattr(e, "activity_type", lambda: "")()).lower()
            if "annotation" in act or e.is_user_annotation():
                continue
            if e.device_index() in (index, -1):
                device.append((name, s, end))
        else:
            if name == "cardbench.window":
                window = (s, end)
            host.append((name, s, end))
    if window is None:
        raise RuntimeError("the profile holds no cardbench.window span")
    return device, host, window


# --------------------------------------------------------------------- #
# one run                                                               #
# --------------------------------------------------------------------- #

class Phases:
    """Host seconds of each phase of set-up, for the info line: where a
    run's ``setup_s`` went."""

    def __init__(self, t_start: float):
        self.last = t_start
        self.seconds: Dict[str, float] = {}

    def mark(self, name: str, sync=None) -> None:
        if sync is not None:
            sync()
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.last
        self.last = now


def run(cell: specs.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: Optional[float] = None, phases: Optional[Phases] = None,
        wrap: Optional[Callable] = None, make_call: Optional[Callable] = None,
        keep: Optional[dict] = None) -> dict:
    """One run of ``cell`` in this process.  ``phases`` times set-up from
    ``t_start`` on.  ``wrap(call)`` puts a fault under the program's entry,
    ``make_call(config, det_state, cls_state, batch, device)`` another
    program in its place (the control); ``keep`` receives the judge's
    per-slot and per-frame gaps; all three for the benchmark's own checks
    only."""
    import numpy as np
    import torch
    from torch.profiler import record_function

    from cardbench import judge, program, traffic as gen, yardstick
    from cardbench.reference.two_stage import Reference
    from cardbench.weights import make_states

    t_start = time.perf_counter() if t_start is None else t_start
    phases = phases or Phases(t_start)
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else None
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    phases.mark("device", sync)
    batch = tr["batch"]
    det_state, cls_state = make_states(cfg, seed, dev)
    phases.mark("weights", sync)
    builder = make_call or program.build
    call = builder(cfg, det_state, cls_state, batch, dev)
    if wrap is not None:
        call = wrap(call)
    phases.mark("program", sync)

    rng = np.random.default_rng(seed)
    pool = gen.device_pool(tr, seed, dev)
    items = len(pool)
    check = sorted(rng.choice(items, size=min(tr["check_batches"], items), replace=False).tolist())
    phases.mark("frames", sync)
    flight = Flight(torch, dev, tr["in_flight"], keep=range(items))

    # warm-up: the cell's own shapes, through the window's own path; then
    # the steady time per batch, which sets the window's batch count
    closed_loop(call, pool, flight, tr["warmup_batches"], record_function)
    phases.mark("warmup")
    paced = closed_loop(call, pool, flight, tr["warmup_batches"], record_function)
    per_batch_s = max(1e-4, (paced["t_last"] - paced["t_first"]) / tr["warmup_batches"])
    program.reset_launch_counts()
    phases.mark("pace")

    tail_s = min(2.0, seconds / 4.0) if trace else 0.0
    n_main = max(1, round((seconds - tail_s) / per_batch_s))
    res = closed_loop(call, pool, flight, n_main, record_function)
    setup_s = res["t_first"] - t_start
    elapsed = res["t_last"] - res["t_first"]
    attempted = n_main * batch
    failed = (n_main - res["completed"]) * batch
    stats = {"frames_per_s": res["completed"] * batch / elapsed, "window_s": elapsed,
             "batches": n_main}
    collected: Dict = {"batch": batch, "frames_per_s": stats["frames_per_s"]}
    launches = program.launch_counts()

    busy_s = window_s = None
    if trace:
        prof = profiler(torch)
        n_traced = max(1, round(tail_s / per_batch_s))
        with prof:
            with record_function("cardbench.window"):
                closed_loop(call, pool, flight, n_traced, record_function)
        device_ev, host_ev, (lo, hi) = trace_events(prof, torch, dev.index or 0)
        del prof
        busy_s = yardstick.union_ns(device_ev, lo, hi) / 1e9
        window_s = (hi - lo) / 1e9
        collected.update(device=device_ev, host=host_ev, window_ns=(lo, hi),
                         batches_traced=n_traced)
    flight.close()

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kept = dict(flight.kept)
    del call, flight
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"cardbench: forbidden modules loaded: {', '.join(bad)}")

    # the comparison, after the window, with the program freed
    ref = Reference(cfg, det_state, cls_state, dev)
    ref_bf16 = Reference(cfg, det_state, cls_state, dev, quant="bf16")
    batches = [(pool[item], kept[item]) for item in check if item in kept]
    numbers = (judge.judge(ref, ref_bf16, batches, keep) if batches
               else {k: float("nan") for k in judge.NUMBERS})
    del ref, ref_bf16
    correct = bool(batches) and judge.verdict(numbers, cell.limits)

    if trace:
        collected.update(trace_counts(cfg, tr, kept))

    result = {"correct": correct, "attempted": int(attempted), "failed": int(failed)}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = specs.reader(m["name"])(collected)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, "frames_per_s": stats["frames_per_s"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if values.get(m["name"]) is not None}
    result["metrics"] = metrics
    result["device"] = device_info(torch, dev, peak, busy_s, window_s)
    if trace:
        lo, hi = collected["window_ns"]
        result["breakdown"] = {
            "device_ops": yardstick.top_ops(collected["device"], lo, hi),
            "idle_gaps": yardstick.idle_gaps(collected["device"], collected["host"], lo, hi)}
    result["checks"] = {k: {"value": numbers[k], "limit": v} for k, v in cell.limits.items()}
    info = {"launches": launches, "window": stats, "setup_s": setup_s,
            "setup_phases_s": phases.seconds, "s_per_batch_estimate": per_batch_s,
            "checked_batches": len(batches),
            "judged": {k: v for k, v in numbers.items() if k not in cell.limits}}
    return {"result": result, "info": info}


def trace_counts(cfg: dict, tr: dict, kept: Dict[int, Dict]) -> dict:
    """What the traced run's readers take from the configuration, the
    shapes and the kept outputs: model FLOPs per frame, and the operations
    and bytes of one K3 call (canvas-sized frames into the default
    detector) and of one K2 call (the mean over the kept batches' boxes)."""
    import torch

    from cardbench import yardstick
    from cardbench.reference.layers import make_divisible
    from cardbench.reference.two_stage import build_model

    det, cls, sv = cfg["detector"], cfg["classifier"], cfg["serving"]
    s, crop = det["input_size"], cls["input_size"]
    out = {"flops_per_frame": (
        yardstick.model_flops(lambda: build_model(det), (1, 3, s, s))
        + yardstick.model_flops(lambda: build_model(cls),
                                (sv["cls_crop_budget_per_frame"], 3, crop, crop)))}
    h, w = tr["height"], tr["width"]
    if not det.get("variant") and (h, w) == (s, s):
        out["stem_counts"] = yardstick.stem_counts(
            tr["batch"], h, w, make_divisible(det["base_channels"][0] * det["width"]))
    roi = []
    for got in kept.values():
        boxes = torch.as_tensor(got["boxes"])
        valid = (torch.as_tensor(got["det_scores"]) > sv["conf_threshold"]) & (
            (boxes[..., 2] - boxes[..., 0]).clamp(min=0)
            * (boxes[..., 3] - boxes[..., 1]).clamp(min=0) >= sv["min_area"])
        roi.append(yardstick.roi_counts(boxes, valid, h, w, crop))
    if roi:
        out["roi_counts"] = tuple(sum(c[i] for c in roi) / len(roi) for i in range(2))
    return out


def device_info(torch, dev, peak, busy_s, window_s) -> dict:
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": int(peak)}
    if busy_s is not None:
        info.update(busy_s=busy_s, window_s=window_s)
    limit = power_limit()
    if limit:
        info["power_limit"] = limit
    return info


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


# --------------------------------------------------------------------- #
# command line                                                          #
# --------------------------------------------------------------------- #

def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m cardbench", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    t_start = process_start_perf()
    phases = Phases(t_start)
    phases.mark("python")
    args = parse(argv)
    pin_caches(specs.ROOT)
    cell = specs.resolve(args.workload)
    if cell.chips != 1:
        print(f"cardbench: cell {cell.name} asks for {cell.chips} chips; the harness drives one",
              file=sys.stderr)
        return 2
    import torch

    phases.mark("torch_import")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"cardbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    phases.mark("cuda_init")
    from cardbench import program

    program.build_kernels()
    phases.mark("kernels")
    out = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start, phases)
    result = out["result"]
    print(json.dumps(out["info"]))
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
