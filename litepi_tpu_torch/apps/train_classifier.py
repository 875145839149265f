"""Classifier training CLI of the PyTorch port, flag-compatible with the
JAX package's ``apps/train_classifier.py`` (plus ``--device``).

The reference's recipe: ImageFolder 64x64 crops, dataset mean/std,
ColorJitter, MixUp(0.4) / CutMix(1.0) collate at p=0.7, Adam 1e-3 + cosine,
CE loss, grad-clip 1.0, 30 epochs, early-stopping patience 5, checkpoint on
the best validation loss.  The step is ``train/classifier.py``'s (bf16
forward over float32 master weights, dropout drawn from a generator seeded
by (seed, epoch)); ``best`` checkpoints are Flax-named trees
(``weights/checkpoint.py``), and ``--resume`` / ``--stop_after`` continue a
run from its training state.

It runs on the card (``--device cuda``, the default; it raises without
one) or with ``--device cpu``.

Usage:
    python -m litepi_tpu_torch.apps.train_classifier --data crops/train \\
        --val_data crops/val --arch shufflenetv2 --output runs/classifier
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a crop classifier (PyTorch port)")
    p.add_argument("--data", required=True, help="ImageFolder root (train)")
    p.add_argument("--val_data", default=None, help="ImageFolder root (val)")
    p.add_argument(
        "--arch", default="shufflenetv2",
        choices=["shufflenetv2", "resnet18", "mobilenetv2", "efficientnet"],
    )
    p.add_argument("--img_size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--patience", type=int, default=5)
    p.add_argument("--mix_p", type=float, default=0.7)
    p.add_argument("--mean", type=float, nargs=3, default=[0.18, 0.18, 0.18])
    p.add_argument("--std", type=float, nargs=3, default=[0.34, 0.34, 0.34])
    p.add_argument("--steps_per_epoch", type=int, default=None)
    p.add_argument("--output", default="runs/classifier")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument(
        "--resume", action="store_true",
        help="continue from {output}/resume (full state + epoch cursor); "
        "pass the SAME --epochs as the original run: the lr schedule spans "
        "the total epoch budget",
    )
    p.add_argument(
        "--stop_after", type=int, default=None,
        help="stop after N epochs THIS invocation; resume with --resume",
    )
    return p


def dropout_generator(seed: int, epoch: int, device):
    """A generator on ``device`` seeded by (seed, epoch) alone: a resumed
    run draws the uninterrupted run's dropout masks."""
    import numpy as np
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0]))
    return g


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    import numpy as np
    import torch
    import torch.nn.functional as F

    from litepi_tpu_torch.core.device import resolve_device
    from litepi_tpu_torch.data.dataset import CropClassificationDataset, Prefetcher
    from litepi_tpu_torch.models import build_classifier
    from litepi_tpu_torch.train.classifier import (
        classifier_train_step,
        create_classifier_train_state,
    )
    from litepi_tpu_torch.train.detector import forward_in, to_device_batch
    from litepi_tpu_torch.weights.checkpoint import (
        load_train_checkpoint,
        save_checkpoint,
        save_train_checkpoint,
    )
    from litepi_tpu_torch.weights.jax_bridge import state_dict_to_jax

    device = resolve_device(args.device)  # raises without a card
    train_ds = CropClassificationDataset(
        args.data, input_size=args.img_size, mean=args.mean, std=args.std,
        mix_p=args.mix_p, seed=args.seed,
    )
    nc = train_ds.num_classes
    steps = args.steps_per_epoch or max(len(train_ds) // args.batch, 1)
    print(f"train: {len(train_ds)} crops | {nc} classes | {steps} steps/epoch")

    val_ds = None
    if args.val_data:
        val_ds = CropClassificationDataset(
            args.val_data, input_size=args.img_size, mean=args.mean, std=args.std,
            augment=False,
        )

    model = build_classifier(args.arch, nc)
    state, tx = create_classifier_train_state(
        model, seed=args.seed, lr=args.lr, total_steps=steps * args.epochs,
        dtype=torch.bfloat16, device=device,
    )
    model = state.model

    def validate():
        if val_ds is None:
            return float("nan"), float("nan")
        losses, correct, total = [], 0, 0
        model.eval()
        with torch.no_grad():
            for batch in val_ds.batches(args.batch, steps=None, shuffle=False):
                x = to_device_batch({"images": batch["images"]}, device)["images"]
                logits = forward_in(model, state.dtype, x).float().cpu()
                hard = torch.from_numpy(batch["hard_labels"])
                losses.append(float(F.cross_entropy(logits, hard)))
                correct += int((logits.argmax(-1) == hard).sum())
                total += len(hard)
                if len(losses) >= max(len(val_ds) // args.batch, 1):
                    break
        model.train()
        return float(np.mean(losses)), correct / max(total, 1)

    best_val, best_epoch, start_epoch = float("inf"), -1, 0
    os.makedirs(args.output, exist_ok=True)
    resume_dir = os.path.join(args.output, "resume")
    if args.resume and (os.path.isdir(resume_dir) or os.path.isdir(resume_dir + ".old")):
        state, meta = load_train_checkpoint(
            resume_dir, state,
            meta_template={"next_epoch": 0, "best_score": 0.0, "best_epoch": 0},
        )
        start_epoch = int(meta["next_epoch"])
        best_val, best_epoch = float(meta["best_score"]), int(meta["best_epoch"])
        print(f"resumed from {resume_dir}: epoch {start_epoch}, best {best_val:.4f}")
    elif args.resume:
        print(f"--resume: no checkpoint at {resume_dir}, starting fresh")
    for epoch in range(start_epoch, args.epochs):
        t0 = time.perf_counter()
        # (seed, epoch)-pure draws, so a resumed run replays the exact stream
        train_ds.seed_epoch(epoch)
        gen = dropout_generator(args.seed, epoch, device)
        losses, accs = [], []
        for batch in Prefetcher(train_ds.batches(args.batch, steps)):
            tb = to_device_batch({"images": batch["images"], "labels": batch["labels"]}, device)
            state, m = classifier_train_step(model, tx, state, tb, gen)
            losses.append(m["loss"])
            accs.append(m["accuracy"])
        mean_loss = float(np.mean([float(l) for l in losses]))  # waits for the steps
        t1 = time.perf_counter()
        val_loss, val_acc = validate()
        dt, val_dt = time.perf_counter() - t0, time.perf_counter() - t1
        print(
            f"epoch {epoch + 1}/{args.epochs}  loss {mean_loss:.4f}  "
            f"acc {float(np.mean([float(a) for a in accs])):.4f}  "
            f"val_loss {val_loss:.4f}  val_acc {val_acc:.4f}  ({dt:.1f}s, validation {val_dt:.2f}s)"
        )
        score = val_loss if val_loss == val_loss else mean_loss
        if score < best_val:
            best_val, best_epoch = score, epoch
            save_checkpoint(os.path.join(args.output, "best"),
                            state_dict_to_jax(model.state_dict()))
        save_train_checkpoint(
            resume_dir, state,
            {"next_epoch": epoch + 1, "best_score": best_val, "best_epoch": best_epoch},
        )
        if epoch - best_epoch >= args.patience:
            print(f"early stop: no improvement for {args.patience} epochs")
            break
        if args.stop_after and epoch + 1 - start_epoch >= args.stop_after:
            print(f"stopping after {args.stop_after} epochs (resume with --resume)")
            break

    print(f"best val loss {best_val:.4f} at epoch {best_epoch + 1}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
