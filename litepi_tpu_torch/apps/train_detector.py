"""Detector training CLI of the PyTorch port, flag-compatible with the JAX
package's ``apps/train_detector.py`` (plus ``--device``).

The reference trains its detector through Ultralytics (``YOLO(cfg).train(
data, imgsz=640, epochs=30, batch=16, mosaic=0.7, scale=0.5, hsv aug,
patience=5)``); this loop trains it on one card: mosaic / HSV / flip
augmentation on the host (``data/dataset.py``, a background prefetcher),
the train step of ``train/detector.py`` (a bf16 forward over float32
master weights, TAL + CIoU + DFL loss, nesterov SGD over the one-cycle
schedule, EMA), per-epoch validation mAP@0.5 through the port's
``PipelineEvaluator`` (bf16, the EMA weights unless ``--no_ema``),
early-stopping patience, ``best`` / ``last`` checkpoints (Flax-named trees,
``weights/checkpoint.py``), a resumable training state (``--resume``,
``--stop_after``) and ``results.json`` with the JAX CLI's keys.

It runs on the card (``--device cuda``, the default; it raises without
one) or with ``--device cpu``.  ``--data_parallel N`` trains on N ranks of
a ``torch.distributed`` group that the CLI starts itself
(``parallel/multiprocess.py::spawn_ranks``): one card each over NCCL (N
visible cards needed; fewer exit with rc 2), or N CPU processes over gloo
with ``--device cpu``.  As in the JAX package's single-host mesh,
``--batch`` is then the global batch: every rank reads the same batches
and trains on its own contiguous rows, and the step is the global batch's
(``train/detector.py::detector_train_step``'s ``mesh``).  Under
``torchrun`` (``WORLD_SIZE`` set) each process is one rank, as in JAX's
multi-process contract: ``--batch`` is per process and each reads its own
shard of the images (``data/distributed.py``).  Steps per epoch come from
the global image count; only rank 0 prints, validates and writes, and on
``--resume`` the ranks must agree on the resume epoch or the run aborts.

Usage:
    python -m litepi_tpu_torch.apps.train_detector --images train/images \\
        --labels train/labels --val_images val/images --val_labels val/labels \\
        --epochs 30 --batch 16 --output runs/detector
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the YOLO-LitePi detector (PyTorch port)")
    p.add_argument("--images", required=True)
    p.add_argument("--labels", required=True)
    p.add_argument("--val_images", default=None)
    p.add_argument("--val_labels", default=None)
    p.add_argument(
        "--variant", default="yolo_plus_v2",
        choices=["yolo_plus_v2", "yolo_plus_v1", "yolov8n", "yolov11n", "yolov5n"],
        help="yolov5n = the u-variant the reference deployed (anchor-free "
        "DFL head, trains under the same TAL loss as the v8 family)",
    )
    p.add_argument("--num_classes", type=int, default=1)
    p.add_argument(
        "--width_scale", type=float, default=None,
        help="ablation width scale on the v8 base stage widths (yolo_plus/v8 "
        "variants only; w=0.75 reproduces the shipped yolo_plus_v2 base)",
    )
    p.add_argument(
        "--depth_scale", type=float, default=None,
        help="ablation depth scale (C2f repeats; see --width_scale)",
    )
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--patience", type=int, default=5)
    p.add_argument("--mosaic", type=float, default=0.7)
    p.add_argument("--scale", type=float, default=0.5)
    p.add_argument("--max_gt", type=int, default=64)
    p.add_argument("--steps_per_epoch", type=int, default=None)
    p.add_argument("--output", default="runs/detector")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument(
        "--data_parallel", type=int, default=1,
        help="ranks (one device each) to train on, over torch.distributed",
    )
    # validate + checkpoint the EMA weights (the Ultralytics default); raw
    # weights with --no_ema
    p.add_argument("--no_ema", action="store_true")
    p.add_argument(
        "--resume", action="store_true",
        help="continue from {output}/resume (full state: params, EMA, "
        "optimizer state, epoch cursor); pass the SAME --epochs as the "
        "original run: the lr schedule spans the total epoch budget",
    )
    p.add_argument(
        "--stop_after", type=int, default=None,
        help="stop after N epochs THIS invocation (the lr schedule still "
        "spans --epochs); resume later with --resume",
    )
    return p


def detector_config(args):
    """The ``DetectorConfig`` of ``args`` (variant, classes, input size, the
    ablation scales), or an error message."""
    from litepi_tpu_torch.core.types import YOLO_PLUS_V1, YOLO_PLUS_V2, YOLOV8N, ablation_configs

    base = {
        "yolo_plus_v2": YOLO_PLUS_V2,
        "yolo_plus_v1": YOLO_PLUS_V1,
        "yolov8n": YOLOV8N,
        # v11n / v5nu share v8n's stride-8/16/32 grid and reg_max for the
        # TAL loss; their models are injected
        "yolov11n": YOLOV8N,
        "yolov5n": YOLOV8N,
    }[args.variant]
    cfg = dataclasses.replace(base, num_classes=args.num_classes, input_size=args.imgsz)
    if args.width_scale is not None or args.depth_scale is not None:
        if args.variant in ("yolov11n", "yolov5n"):
            return None, ("--width_scale/--depth_scale cover the yolo_plus/yolov8n "
                          "family (the reference's ablation grid)")
        (cfg,) = ablation_configs(
            width_scales=(args.width_scale or 0.75,),
            depth_scales=(args.depth_scale or 0.33,),
            extra=(),
            num_classes=args.num_classes,
        )
        cfg = dataclasses.replace(cfg, input_size=args.imgsz)
    return cfg, None


def custom_detector(variant: str, num_classes: int):
    """The injected zoo model of ``variant`` (None for the yolo_plus /
    yolov8n family, which trains the default YoloLitePi)."""
    from litepi_tpu_torch.models import YoloV5, YoloV11

    if variant == "yolov11n":
        return YoloV11(num_classes=num_classes)
    if variant == "yolov5n":
        return YoloV5(num_classes=num_classes, anchor_free=True)
    return None


def validate(args, cfg, model, state, custom_model, device) -> float:
    """mAP@0.5 of the current weights (EMA unless ``--no_ema``) on the
    validation set, detector level (every class as class 0), through the
    port's ``PipelineEvaluator`` in bf16; NaN without a validation set."""
    if not (args.val_images and args.val_labels):
        return float("nan")
    import cv2
    import numpy as np
    import torch

    from litepi_tpu_torch.core.types import NMSConfig, PipelineConfig
    from litepi_tpu_torch.evals.labels import parse_yolo_label, sample_images
    from litepi_tpu_torch.evals.map import evaluate_predictions
    from litepi_tpu_torch.models import build_classifier
    from litepi_tpu_torch.pipeline import PipelineEvaluator, TwoStagePipeline
    from litepi_tpu_torch.weights.seeded import seeded_state

    pcfg = PipelineConfig(
        detector=cfg,
        nms=NMSConfig(max_candidates=512, max_detections=64, min_area=0.0),
        input_color="bgr",  # val images come via cv2.imread
        num_classifier_classes=max(args.num_classes, 2),
        det_input_size=args.imgsz,
        batch_size=args.batch,
    )
    weights = state.params if args.no_ema else state.ema_params
    det_state = {**model.state_dict(), **{k: v.detach() for k, v in weights.items()}}
    cls_model = build_classifier(pcfg.classifier_arch, pcfg.num_classifier_classes)
    pipe = TwoStagePipeline(
        pcfg, det_state, seeded_state(cls_model, 1), dtype=torch.bfloat16, device=device,
        # the zoo baselines validate through their own model; the yolo_plus
        # family through the pipeline's deploy-form default
        det_model=custom_model,
    )
    ev = PipelineEvaluator(pipe)
    paths = sample_images(args.val_images)
    preds, gts = [], []
    bs = args.batch
    batches = [paths[i : i + bs] for i in range(0, len(paths), bs)]
    if batches and len(batches[-1]) < bs:
        trailing = len(batches[-1])
        batches[-1] = batches[-1] + [batches[-1][-1]] * (bs - trailing)
    else:
        trailing = bs
    for i, b in enumerate(batches):
        real = trailing if i == len(batches) - 1 else bs
        results = ev.run_batch(b, conf_threshold=0.001)
        for path, res in zip(b[:real], results[:real]):
            img = cv2.imread(path)
            h, w = img.shape[:2]
            lbl = os.path.join(
                args.val_labels, os.path.splitext(os.path.basename(path))[0] + ".txt"
            )
            gb, gc = parse_yolo_label(lbl, w, h)
            # detection-level eval: both sides class 0 ("sign"); multi-class
            # GT ids left unmapped would zero the AP of every non-0 class
            gts.append((gb, np.zeros_like(gc)))
            if res is None:
                preds.append((np.zeros((0, 4), np.float32), np.zeros(0), np.zeros(0, np.int32)))
            else:
                preds.append(
                    (res["boxes"], res["det_scores"], np.zeros(len(res["boxes"]), np.int32))
                )
    return evaluate_predictions(preds, gts, num_classes=1)["mAP50"]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_arg_parser().parse_args(argv)
    cfg, error = detector_config(args)
    if error:
        print(f"error: {error}", file=sys.stderr)
        return 2
    launched = int(os.environ.get("WORLD_SIZE", "1")) > 1  # a rank of torchrun
    if args.data_parallel > 1 and not launched:
        from litepi_tpu_torch.parallel.multiprocess import rank_count_error, spawn_ranks

        error = rank_count_error(args.device, args.data_parallel)
        if error:
            print(f"error: {error}", file=sys.stderr)
            return 2
        spawn_ranks("litepi_tpu_torch.apps.train_detector:rank_main", args.data_parallel,
                    {"argv": argv}, device=args.device, rank0_output=True)
        return 0
    return train(args, cfg, per_process=launched)


def rank_main(argv) -> int:
    """One rank of a ``--data_parallel`` run started by :func:`main`."""
    args = build_arg_parser().parse_args(argv)
    cfg, _ = detector_config(args)
    return train(args, cfg, per_process=False)


def train(args, cfg, per_process: bool) -> int:
    import numpy as np
    import torch

    from litepi_tpu_torch.core.device import resolve_device
    from litepi_tpu_torch.data.dataset import DetectionDataset, Prefetcher
    from litepi_tpu_torch.data.distributed import shard_paths
    from litepi_tpu_torch.parallel.mesh import (
        batch_sharding,
        from_rank0,
        make_mesh,
        require_agreement,
    )
    from litepi_tpu_torch.train.detector import (
        create_detector_train_state,
        detector_train_step,
        to_device_batch,
    )
    from litepi_tpu_torch.weights.checkpoint import (
        load_train_checkpoint,
        save_checkpoint,
        save_train_checkpoint,
    )
    from litepi_tpu_torch.weights.jax_bridge import state_dict_to_jax

    mesh = None
    if args.data_parallel > 1 or per_process:
        mesh = make_mesh(args.data_parallel, backend=args.device)
        device = mesh.device
    else:
        device = resolve_device(args.device)  # raises without a card
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    custom_model = custom_detector(args.variant, args.num_classes)
    dataset = DetectionDataset(
        args.images, args.labels, input_size=args.imgsz, max_gt=args.max_gt,
        mosaic_p=args.mosaic, scale=args.scale, seed=args.seed,
    )
    global_images = len(dataset.pairs)
    processes = mesh.size if per_process else 1
    if per_process:
        # one rank per process: each decodes a disjoint shard and --batch is
        # the per-process size (global batch = batch * processes)
        dataset.pairs = shard_paths(dataset.pairs)
    # steps/epoch from the GLOBAL image count: a per-rank count could differ
    # across ranks and desynchronise the collectives and the schedule
    steps = args.steps_per_epoch or max(global_images // (args.batch * processes), 1)
    say(f"dataset: {len(dataset)} images, {steps} steps/epoch")
    if mesh is not None:
        say(f"mesh: {mesh.shape}")
    # every rank reads the global batch and trains on its rows; a torchrun
    # rank's batch is its shard already
    rows = batch_sharding(mesh).shard if mesh is not None and not per_process else None

    # Ultralytics one-cycle lr: 3-epoch linear warmup, cosine to lr*0.01
    model, state, tx = create_detector_train_state(
        cfg, seed=args.seed, lr=args.lr, dtype=torch.bfloat16,
        total_steps=args.epochs * steps, warmup_steps=min(3, args.epochs) * steps,
        model=custom_model, device=device,
    )

    def weights_tree():
        weights = state.params if args.no_ema else state.ema_params
        return state_dict_to_jax({**model.state_dict(), **weights})

    # -inf, not -1: the no-val score is -mean_loss, which starts far below -1
    best_map, best_epoch, start_epoch = float("-inf"), -1, 0
    os.makedirs(args.output, exist_ok=True)
    resume_dir = os.path.join(args.output, "resume")
    found = os.path.isdir(resume_dir) or os.path.isdir(resume_dir + ".old")
    if args.resume:
        require_agreement(mesh, int(found), "--resume: whether a resume point exists")
    if args.resume and found:
        state, meta = load_train_checkpoint(
            resume_dir, state,
            meta_template={"next_epoch": 0, "best_score": 0.0, "best_epoch": 0},
        )
        start_epoch = int(meta["next_epoch"])
        best_map, best_epoch = float(meta["best_score"]), int(meta["best_epoch"])
        require_agreement(mesh, start_epoch, "--resume: the resume epoch")
        say(f"resumed from {resume_dir}: epoch {start_epoch}, step {state.step}, "
            f"best {best_map:.4f}")
    elif args.resume:
        say(f"--resume: no checkpoint at {resume_dir}, starting fresh")
    epoch = start_epoch - 1  # keeps results.json sane when the loop is empty
    for epoch in range(start_epoch, args.epochs):
        t0 = time.perf_counter()
        # epoch-seeded cursor: a resumed run sees exactly the batches the
        # uninterrupted run would have
        dataset.seed_epoch(epoch)
        losses = []
        for batch in Prefetcher(dataset.batches(args.batch, steps)):
            if rows is not None:
                batch = {k: rows(v) for k, v in batch.items()}
            state, metrics = detector_train_step(
                model, tx, state, to_device_batch(batch, device), cfg=cfg, mesh=mesh
            )
            losses.append(metrics["loss"])
        mean_loss = float(np.mean([float(l) for l in losses]))  # waits for the steps
        t1 = time.perf_counter()
        val_map = validate(args, cfg, model, state, custom_model, device) if lead else 0.0
        val_map = from_rank0(mesh, val_map)
        dt, val_dt = time.perf_counter() - t0, time.perf_counter() - t1
        say(f"epoch {epoch + 1}/{args.epochs}  loss {mean_loss:.4f}  "
            f"val mAP50 {val_map:.4f}  ({dt:.1f}s, validation {val_dt:.2f}s)")
        score = val_map if val_map == val_map else -mean_loss  # NaN -> loss
        if score > best_map:
            best_map, best_epoch = score, epoch
            if lead:
                save_checkpoint(os.path.join(args.output, "best"), weights_tree())
        save_train_checkpoint(
            resume_dir, state,
            {"next_epoch": epoch + 1, "best_score": best_map, "best_epoch": best_epoch},
        )
        if epoch - best_epoch >= args.patience:
            say(f"early stop: no improvement for {args.patience} epochs")
            break
        if args.stop_after and epoch + 1 - start_epoch >= args.stop_after:
            say(f"stopping after {args.stop_after} epochs (resume with --resume)")
            break

    if not lead:
        return 0
    save_checkpoint(os.path.join(args.output, "last"), weights_tree())
    with open(os.path.join(args.output, "results.json"), "w") as f:
        json.dump(
            {
                "variant": args.variant,
                "config": cfg.name,
                # null when no val set was given
                "best_map50": round(best_map, 6) if best_epoch >= 0 else None,
                "best_epoch": best_epoch + 1 if best_epoch >= 0 else None,
                "epochs_run": epoch + 1,
            },
            f,
        )
    print(f"best score {best_map:.4f} at epoch {best_epoch + 1}; checkpoints in {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
