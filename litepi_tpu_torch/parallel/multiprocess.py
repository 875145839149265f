"""Starting the ranks of a mesh, and the multi-process dryrun flow.

:func:`spawn_ranks` starts N processes, ``python -m
litepi_tpu_torch.parallel.multiprocess`` each, joins them in one
``torch.distributed`` group through a ``file://`` rendezvous of their own
(no port to collide with another run) and calls one function in each.
Every rank carries a collective timeout, the spawn a wall-clock limit, and
the first rank that fails or outlives the limit takes every other rank
down with it: a failed rank is never waited for, and never replaced by a
run on another device.  NCCL (the card's backend) takes one card per rank;
gloo takes CPU tensors, or the card's, staged through the host, so two
gloo ranks may share one card (a correctness check, never a throughput
number).  The training CLIs' ``--data_parallel`` starts its ranks here.

:func:`run_multiprocess_dryrun` is the port of the JAX package's dryrun
(``litepi_tpu/parallel/multiprocess.py``): at 1 rank and at N ranks, over
the same global batch, each rank runs

1. ``shard_paths`` disjointness / completeness over an odd-sized dataset,
2. one float32 detector train step on a ``make_global_batch`` batch,
3. fused two-stage serving through ``MeshServer.serve_local`` on a
   rank-local feed of canvas-sized frames (on the card the stem, NMS and
   ROI kernels run), with a classifier budget that binds,
4. ``save_train_checkpoint`` -> a crash between the swap's renames ->
   ``load_train_checkpoint`` under the ranks' barrier,

and the two runs are compared: the served outputs bit-equal on the CPU
(per-frame compute; on the card, whose convolutions may pick another
algorithm at another batch size, discrete outputs equal and floats within
the float32 pipeline's tolerances), the train loss and the parameter
checksum within 1e-6 relative, JAX's own bound: they cross a gradient
all-reduce whose summation order is a topology choice.  Float32 runs with
TF32 off.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import importlib
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
# a rank's collectives give up after this long when the spawn sets no limit
DEFAULT_COLLECTIVE_TIMEOUT = 1800.0


def default_backend(device: str) -> str:
    return "nccl" if device == "cuda" else "gloo"


def rank_count_error(device: str, ranks: int) -> Optional[str]:
    """Why ``ranks`` ranks of a CLI cannot run on ``device`` (None when
    they can): NCCL on the card takes one visible card per rank."""
    import torch

    cards = torch.cuda.device_count()
    if device == "cuda" and ranks > cards:
        return (f"--data_parallel {ranks} needs {ranks} visible CUDA devices, one per "
                f"rank; {cards} visible (--device cpu trains on CPU ranks)")
    return None


def spawn_ranks(
    target: str,
    world_size: int,
    kwargs: Optional[Dict[str, Any]] = None,
    device: str = "cuda",
    backend: Optional[str] = None,
    timeout: Optional[float] = None,
    threads: Optional[int] = None,
    rank0_output: bool = False,
) -> List[Any]:
    """Run ``target`` (``"package.module:function"``) in ``world_size``
    ranks of one group on ``device`` (``"cuda"``: the card, the default;
    ``"cpu"``), each called as ``function(**kwargs)`` after the group is up;
    returns every rank's return value, rank order.

    ``backend``: ``"nccl"`` (the default on the card; one card per rank)
    or ``"gloo"`` (the default on the CPU).  ``timeout`` (seconds): the
    spawn's wall-clock limit and each rank's collective timeout (without it
    the ranks run as long as they need and a collective gives up after
    ``DEFAULT_COLLECTIVE_TIMEOUT``).  ``threads``: torch's intra-op threads
    per rank.  ``rank0_output``: rank 0 writes to this process's stdout /
    stderr as it runs (the CLIs); otherwise each rank writes to a log whose
    tail a failure reports.  Raises ``ValueError`` for NCCL with more ranks
    than visible cards, ``RuntimeError`` when a rank fails and
    ``TimeoutError`` past ``timeout``; every rank is stopped either way.
    """
    import torch

    from litepi_tpu_torch.core.device import resolve_device

    backend = backend or default_backend(device)
    resolve_device(device)  # raises without a card
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise ValueError(
            f"{world_size} ranks over NCCL need {world_size} visible cards; "
            f"{torch.cuda.device_count()} visible"
        )
    with tempfile.TemporaryDirectory(prefix="litepi_ranks_") as tmp:
        args_file = os.path.join(tmp, "kwargs.pt")
        torch.save(kwargs or {}, args_file)
        procs, logs, outs = [], [], []
        env = dict(os.environ, WORLD_SIZE=str(world_size))
        try:
            for rank in range(world_size):
                out = os.path.join(tmp, f"rank{rank}.pt")
                log_path = os.path.join(tmp, f"rank{rank}.log")
                outs.append(out)
                logs.append(log_path)
                argv = [
                    sys.executable, "-m", "litepi_tpu_torch.parallel.multiprocess",
                    "--target", target, "--rank", str(rank),
                    "--world-size", str(world_size),
                    "--init-method", "file://" + os.path.join(tmp, "rendezvous"),
                    "--backend", backend, "--device", device, "--kwargs", args_file,
                    "--out", out, "--timeout", str(timeout or DEFAULT_COLLECTIVE_TIMEOUT),
                ]
                if threads:
                    argv += ["--threads", str(threads)]
                if rank == 0 and rank0_output:
                    sink = None
                else:
                    sink = open(log_path, "w")
                procs.append(subprocess.Popen(
                    argv, stdout=sink, stderr=subprocess.STDOUT if sink else None,
                    env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)), cwd=_REPO_ROOT,
                ))
                if sink is not None:
                    sink.close()
            _wait_all(procs, logs, timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return [torch.load(out, weights_only=False) for out in outs]


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path) as f:
            return f.read()[-n:]
    except OSError:
        return "(no log: the rank wrote to this process's output)"


def _wait_all(procs, logs, timeout: Optional[float]) -> None:
    """Wait for every rank; at the first failure or past ``timeout``, raise
    (the caller kills the rest)."""
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        running = 0
        for rank, p in enumerate(procs):
            rc = p.poll()
            if rc is None:
                running += 1
            elif rc != 0:
                raise RuntimeError(f"rank {rank} failed (rc={rc}):\n{_tail(logs[rank])}")
        if not running:
            return
        if deadline is not None and time.monotonic() > deadline:
            raise TimeoutError(
                f"ranks still running after {timeout} s; stopped.\nrank 0:\n{_tail(logs[0])}"
            )
        time.sleep(0.05)


def worker_main(argv=None) -> int:
    """One rank: join the group, call the target, save its return value."""
    p = argparse.ArgumentParser()
    p.add_argument("--target", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--init-method", required=True)
    p.add_argument("--backend", required=True)
    p.add_argument("--device", required=True)
    p.add_argument("--kwargs", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--timeout", type=float, required=True)
    p.add_argument("--threads", type=int, default=None)
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from litepi_tpu_torch.parallel.mesh import rank_device

    if args.threads:
        torch.set_num_threads(args.threads)
    bound = {}
    if args.device == "cuda" and args.backend == "nccl":
        # NCCL's communicator on this rank's card (its barrier uses it too)
        bound["device_id"] = rank_device("cuda", args.rank)
        torch.cuda.set_device(bound["device_id"])
    dist.init_process_group(
        args.backend, init_method=args.init_method, rank=args.rank,
        world_size=args.world_size, timeout=datetime.timedelta(seconds=args.timeout), **bound,
    )
    try:
        module, name = args.target.split(":")
        fn = getattr(importlib.import_module(module), name)
        result = fn(**torch.load(args.kwargs, weights_only=False))
        torch.save(result, args.out)
    finally:
        dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------- #
# the dryrun flow                                                         #
# ---------------------------------------------------------------------- #

TRAIN_BATCH = 4  # the global batch of the train step
SERVE_BATCH = 8  # the global batch of the served frames
SERVE_SIZE = 160  # their size: the detector's input, canvas-sized
SERVE_KEYS = ("boxes", "det_scores", "det_class_ids", "valid", "cls_probs", "cls_labels",
              "cls_scores")


def _worker_flow(shared_dir: str, device: str = "cuda") -> Dict[str, Any]:
    """The flow under test; runs identically at 1 rank and at N.  Returns
    the scalars and the served outputs compared across rank counts, and
    the rank's kernel launch counts over the flow."""
    import torch
    import torch.distributed as dist

    from litepi_tpu_torch.core.types import DetectorConfig, NMSConfig, PipelineConfig
    from litepi_tpu_torch.data.distributed import make_global_batch, shard_paths
    from litepi_tpu_torch.kernels import launch_counts, reset_launch_counts
    from litepi_tpu_torch.parallel.mesh import (
        all_gather_rows,
        batch_sharding,
        make_mesh,
        put_replicated,
    )
    from litepi_tpu_torch.pipeline import TwoStagePipeline
    from litepi_tpu_torch.pipeline.serving import MeshServer
    from litepi_tpu_torch.train.detector import (
        create_detector_train_state,
        detector_train_step,
    )
    from litepi_tpu_torch.weights.checkpoint import (
        load_train_checkpoint,
        save_train_checkpoint,
    )
    from litepi_tpu_torch.weights.graph_ops import tf32_allowed

    mesh = make_mesh(backend=device)
    group = mesh.data_group
    rows = batch_sharding(mesh).rows
    reset_launch_counts()

    # -- 1. dataset sharding: strided shards partition an odd-sized set --
    paths = [f"img_{i:03d}.jpg" for i in range(19)]
    owned = torch.zeros(len(paths), dtype=torch.int32, device=mesh.device)
    owned[[int(p[4:7]) for p in shard_paths(paths)]] = 1
    coverage = all_gather_rows(owned[None], group).sum(dim=0)
    if not bool((coverage == 1).all()):
        raise RuntimeError(f"shard_paths overlap/gap: coverage={coverage.tolist()}")

    # -- 2. one train step on a globally assembled batch ------------------
    cfg = DetectorConfig(
        name="dryrun_tiny", base_channels=(32, 64, 128, 256, 512), input_size=64
    )
    rng = np.random.default_rng(0)
    b, g = TRAIN_BATCH, 4
    full_batch = {
        "images": rng.uniform(0, 1, (b, 64, 64, 3)).astype(np.float32),
        "gt_boxes": np.tile(np.asarray([8.0, 8.0, 40.0, 40.0], np.float32), (b, g, 1)),
        "gt_labels": np.zeros((b, g), np.int32),
        "gt_mask": np.ones((b, g), bool),
    }
    local_batch = {k: v[rows(b)] for k, v in full_batch.items()}
    with tf32_allowed(False):
        model, state, tx = create_detector_train_state(
            cfg, dtype=torch.float32, device=mesh.device)
        state = put_replicated(state, mesh)
        batch = make_global_batch(mesh, local_batch)
        batch["images"] = batch["images"].permute(0, 3, 1, 2)  # the step's NCHW
        state, metrics = detector_train_step(model, tx, state, batch, cfg=cfg, mesh=mesh)
        put_replicated(state, mesh)  # the ranks' states stay identical
    loss = float(metrics["loss"])
    param_sum = float(sum(float(p.detach().abs().double().sum()) for p in model.parameters()))

    # -- 3. fused serving on a rank-local frame feed ----------------------
    # canvas-sized frames at a size the stem kernel takes (a multiple of 80),
    # so that on the card the flow runs all three kernels
    size = SERVE_SIZE
    pcfg = PipelineConfig(
        detector=dataclasses.replace(cfg, input_size=size),
        nms=NMSConfig(max_candidates=64, max_detections=8),
        det_input_size=size,
        cls_input_size=32,
        num_classifier_classes=7,
        # binds: 20 of the batch's 64 slots, not a multiple of a rank's
        cls_crop_budget=20,
    )
    pipe = TwoStagePipeline.initialize(pcfg, seed=0, dtype=torch.float32, device=mesh.device)
    frames_full = rng.integers(0, 256, (SERVE_BATCH, size, size, 3), np.uint8)
    server = MeshServer(pipe, mesh)
    served = server.gather(
        server.serve_local(frames_full[rows(SERVE_BATCH)], conf_threshold=0.01))

    # -- 4. resume promotion under the ranks' barrier ----------------------
    ck = os.path.join(shared_dir, "resume")
    save_train_checkpoint(ck, state, {"next_epoch": 3, "best_score": 0.5})
    if mesh.rank == 0:  # simulate preemption between the two renames of the swap
        os.rename(ck, ck + ".old")
    if dist.is_initialized():
        dist.barrier()
    _, fresh, _ = create_detector_train_state(cfg, seed=1, dtype=torch.float32,
                                              device=mesh.device)
    restored, meta = load_train_checkpoint(ck, fresh, {"next_epoch": 0, "best_score": 0.0})
    if meta["next_epoch"] != 3:
        raise RuntimeError(f"resume meta lost: {meta}")
    restored_sum = float(sum(float(p.detach().abs().double().sum())
                             for p in restored.model.parameters()))
    if restored_sum != param_sum:
        raise RuntimeError(f"restored params diverge: {restored_sum} != {param_sum}")

    return {
        "processes": mesh.size,
        "loss": loss,
        "param_sum": param_sum,
        "served": {k: served[k].cpu().numpy() for k in SERVE_KEYS},
        "launches": launch_counts(),  # this rank's kernel launches (0 on the CPU)
    }


# the float32 pipeline's tolerances card vs CPU (chip_smoke.py's
# check_small_pipeline): boxes in pixels, scores, probabilities
CARD_TOLERANCES = {"boxes": 1e-2, "det_scores": 1e-5, "cls_probs": 1e-4, "cls_scores": 1e-4}


def compare_runs(single: Dict[str, Any], multi: Dict[str, Any], exact: bool) -> Dict[str, Any]:
    """The differences between a 1-rank and an N-rank result that break
    the flow's contract (empty when it holds); see the module docstring."""
    bad = {}
    for k in ("loss", "param_sum"):
        if not math.isclose(single[k], multi[k], rel_tol=1e-6):
            bad[k] = (single[k], multi[k])
    for k in SERVE_KEYS:
        a, b = single["served"][k], multi["served"][k]
        if a.shape != b.shape:
            bad[k] = (a.shape, b.shape)
        elif exact or k not in CARD_TOLERANCES:
            if not np.array_equal(a, b):
                bad[k] = f"{int((a != b).sum())} elements differ"
        else:
            err = float(np.abs(a.astype(np.float64) - b).max(initial=0.0))
            if err > CARD_TOLERANCES[k]:
                bad[k] = f"max abs err {err} > {CARD_TOLERANCES[k]}"
    return bad


def run_multiprocess_dryrun(
    num_processes: int = 2,
    device: str = "cuda",
    backend: Optional[str] = None,
    timeout: float = 900.0,
    threads: Optional[int] = None,
) -> Dict[str, Any]:
    """Run the flow at 1 rank and at ``num_processes`` ranks over the same
    global batches on ``device`` and check the contract of the module
    docstring; returns ``{"single": ..., "multi": ...}`` (rank 0's results),
    and raises on any divergence.  ``backend`` as in :func:`spawn_ranks`
    (gloo lets the ranks share one card)."""
    results = {}
    with tempfile.TemporaryDirectory(prefix="litepi_dryrun_") as tmp:
        for tag, n in (("single", 1), ("multi", num_processes)):
            shared = os.path.join(tmp, tag)
            os.makedirs(shared)
            results[tag] = spawn_ranks(
                "litepi_tpu_torch.parallel.multiprocess:_worker_flow", n,
                {"shared_dir": shared, "device": device}, device=device, backend=backend,
                timeout=timeout, threads=threads,
            )[0]
    bad = compare_runs(results["single"], results["multi"], exact=device == "cpu")
    if bad:
        raise RuntimeError(f"multi-rank results diverge from single-rank: {bad}")
    return results


if __name__ == "__main__":
    sys.exit(worker_main())
