"""Baseline detector training CLI of the PyTorch port: Faster R-CNN and
SSD300, flag-compatible with the JAX package's ``apps/train_baselines.py``
(``--device`` takes ``cuda`` / ``cpu``).

The reference's recipes (train-other-model-tsd-tt100k.ipynb cell 11:
Faster R-CNN ResNet50-FPN, SGD lr 1e-4 momentum 0.9 weight decay 5e-4,
StepLR(3, 0.1), batch 8, 30 epochs; cell 13: SSD300-VGG16, AdamW lr 1e-4
weight decay 1e-4, cosine annealing) as the JAX CLI runs them: the models
of ``models/{faster_rcnn,ssd}.py`` under the losses of
``train/{frcnn,ssd}_loss.py`` (``train/baselines.py``), fed by the shared
``DetectionDataset``, from random weights (the reference starts from
ImageNet weights; none are downloaded here), with ``best`` / ``last``
checkpoints (Flax-named trees, ``weights/checkpoint.py``) that ``python -m
litepi_tpu_torch.bench.detector_bench --checkpoint`` loads, per-epoch
validation mAP@0.5 through ``bench/detector_bench.py::evaluate_detector``
and ``results.json`` with the JAX CLI's keys.

It runs on the card (``--device cuda``, the default; it raises without
one) or with ``--device cpu``.  On the card the RPN's NMS is the NMS kernel
at K = ``--pre_nms_topk`` (any value, as in JAX: torchvision trains this
baseline at 2,000).  ``--data_parallel N`` trains on N ranks that the CLI
starts itself, as ``apps/train_detector.py`` does (one card each over
NCCL, N visible cards needed, else rc 2; gloo CPU ranks with ``--device
cpu``): ``--batch`` is the global batch, every rank reads the same batches
and trains on its own rows, and the step is the global batch's
(``train/baselines.py::baseline_train_step``'s ``mesh``).  Only rank 0
prints, validates and writes.

Usage:
    python -m litepi_tpu_torch.apps.train_baselines --arch faster_rcnn \\
        --images train/images --labels train/labels --val_images val/images \\
        --val_labels val/labels --epochs 30 --batch 8 --output runs/frcnn
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train the Faster-RCNN / SSD300 baseline detectors (PyTorch port)"
    )
    p.add_argument("--arch", required=True, choices=["faster_rcnn", "ssd300"])
    p.add_argument("--images", required=True)
    p.add_argument("--labels", required=True)
    p.add_argument("--val_images", default=None)
    p.add_argument("--val_labels", default=None)
    p.add_argument("--num_classes", type=int, default=1,
                   help="foreground classes (background is internal: the "
                   "reference's NUM_CLASSES=2 includes it)")
    p.add_argument("--imgsz", type=int, default=None,
                   help="default: 640 (faster_rcnn) / 300 (ssd300, fixed by the "
                   "default-box grid)")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--max_gt", type=int, default=64)
    p.add_argument("--steps_per_epoch", type=int, default=None)
    p.add_argument("--output", default="runs/baseline")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--data_parallel", type=int, default=1,
                   help="ranks (one device each) to train on, over torch.distributed")
    # the Faster R-CNN proposal budgets (shrunk for tiny runs)
    p.add_argument("--pre_nms_topk", type=int, default=1024)
    p.add_argument("--post_nms_topk", type=int, default=256)
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_arg_parser().parse_args(argv)
    if args.arch == "ssd300" and args.imgsz not in (None, 300):
        print("error: ssd300 input is fixed at 300 (default-box grid)", file=sys.stderr)
        return 2
    if args.data_parallel > 1:
        from litepi_tpu_torch.parallel.multiprocess import rank_count_error, spawn_ranks

        error = rank_count_error(args.device, args.data_parallel)
        if error:
            print(f"error: {error}", file=sys.stderr)
            return 2
        spawn_ranks("litepi_tpu_torch.apps.train_baselines:rank_main", args.data_parallel,
                    {"argv": argv}, device=args.device, rank0_output=True)
        return 0
    return train(args)


def rank_main(argv) -> int:
    """One rank of a ``--data_parallel`` run started by :func:`main`."""
    return train(build_arg_parser().parse_args(argv))


def train(args) -> int:
    import numpy as np
    import torch

    from litepi_tpu_torch.core.device import resolve_device
    from litepi_tpu_torch.parallel.mesh import batch_sharding, from_rank0, make_mesh

    mesh = None
    if args.data_parallel > 1:
        mesh = make_mesh(args.data_parallel, backend=args.device)
        device = mesh.device
    else:
        device = resolve_device(args.device)  # raises without a card
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)

    from litepi_tpu_torch.data.dataset import DetectionDataset, Prefetcher
    from litepi_tpu_torch.train.baselines import baseline_train_step, create_baseline_train_state
    from litepi_tpu_torch.train.detector import to_device_batch
    from litepi_tpu_torch.weights.checkpoint import save_checkpoint
    from litepi_tpu_torch.weights.jax_bridge import state_dict_to_jax

    imgsz = args.imgsz or (300 if args.arch == "ssd300" else 640)
    dataset = DetectionDataset(args.images, args.labels, input_size=imgsz,
                               max_gt=args.max_gt, seed=args.seed)
    steps = args.steps_per_epoch or max(len(dataset) // args.batch, 1)
    say(f"dataset: {len(dataset)} images, {steps} steps/epoch")
    if mesh is not None:
        say(f"mesh: {mesh.shape}")
    # every rank reads the global batch and trains on its own rows
    rows = batch_sharding(mesh).shard if mesh is not None else None
    state, tx = create_baseline_train_state(
        args.arch, args.num_classes, imgsz, seed=args.seed, lr=args.lr, epochs=args.epochs,
        steps_per_epoch=steps, pre_nms_topk=args.pre_nms_topk,
        post_nms_topk=args.post_nms_topk, dtype=torch.bfloat16, device=device)
    # the Faster R-CNN loss's sampling draws (JAX: jax.random keys per step),
    # seeded alike on every rank: each takes its rows of the global draws
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def current_vars():
        return state_dict_to_jax(state.model.state_dict())

    def validate() -> float:
        if not (args.val_images and args.val_labels):
            return float("nan")
        from litepi_tpu_torch.bench.detector_bench import evaluate_detector

        row = evaluate_detector(args.arch, args.val_images, args.val_labels,
                                det_vars=current_vars(), num_classes=args.num_classes,
                                input_size=imgsz, conf=0.001, device=device)
        return float(row["mAP50"])

    best_score, best_epoch = float("-inf"), -1
    os.makedirs(args.output, exist_ok=True)
    epoch = -1
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        dataset.seed_epoch(epoch)
        losses = []
        for batch in Prefetcher(dataset.batches(args.batch, steps)):
            if rows is not None:
                batch = {k: rows(v) for k, v in batch.items()}
            state, metrics = baseline_train_step(state, tx, to_device_batch(batch, device),
                                                 draws=gen, mesh=mesh)
            losses.append(metrics["loss"])
        mean_loss = float(np.mean([float(l) for l in losses]))  # waits for the steps
        t1 = time.perf_counter()
        val_map = from_rank0(mesh, validate() if lead else 0.0)
        dt, val_dt = time.perf_counter() - t0, time.perf_counter() - t1
        say(f"epoch {epoch + 1}/{args.epochs}  loss {mean_loss:.4f}  "
            f"val mAP50 {val_map:.4f}  ({dt:.1f}s, validation {val_dt:.2f}s)")
        score = val_map if val_map == val_map else -mean_loss  # NaN -> loss
        if score > best_score:
            best_score, best_epoch = score, epoch
            if lead:
                save_checkpoint(os.path.join(args.output, "best"), current_vars())
        if epoch - best_epoch >= args.patience:
            say(f"early stop: no improvement for {args.patience} epochs")
            break

    if not lead:
        return 0
    save_checkpoint(os.path.join(args.output, "last"), current_vars())
    with open(os.path.join(args.output, "results.json"), "w") as f:
        json.dump({
            "arch": args.arch,
            "best_score": round(best_score, 6) if best_epoch >= 0 else None,
            "best_epoch": best_epoch + 1 if best_epoch >= 0 else None,
            "epochs_run": epoch + 1,
        }, f)
    print(f"best score {best_score:.4f} at epoch {best_epoch + 1}; checkpoints in {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
