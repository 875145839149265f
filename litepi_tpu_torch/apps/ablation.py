"""Width/depth ablation runner of the PyTorch port — the reference's ablation
study as a CLI, flag-compatible with the JAX package's ``apps/ablation.py``
(plus ``--device``).

The reference's ``train_model/revision-ablation-study.ipynb`` sweeps the
detector's width/depth grid (w in {0.5, 0.75, 1.0} x d 0.33, plus
(0.75, 0.67); cell 6 generator, cell 12 runner) and tabulates params / FPS /
mAP@0.5 per variant.  Its generator's ``width_multiple`` was *ignored* by
Ultralytics, so the published ablation trained ~8x larger models than
intended (SURVEY §6 footnote); the configs here apply the scales.

Two modes:

* **static** (default): per variant, the parameter count and the forward
  GFLOPs at ``--imgsz``, counted by ``torch.utils.flop_counter.
  FlopCounterMode`` (2 per multiply-add of the convolutions; the JAX CLI's
  XLA cost analysis also counts the elementwise work, BatchNorm and SiLU,
  a few percent more), and with ``--bench`` the forward's FPS at batch
  ``--bench_batch`` (float32, timed with CUDA events over
  ``--bench_iters`` forwards after one warm-up; the host clock with
  ``--device cpu``).
* **--train**: also runs ``apps/train_detector.py`` per variant on the
  given dataset (``--device`` passed on) and harvests its ``results.json``
  (best mAP@0.5 / epoch), the notebook's accuracy column.

Writes one CSV row per variant (cell 12's table shape):
``name,width_scale,depth_scale,params,gflops,fps,map50,best_epoch``.
It runs on the card (``--device cuda``, the default; it raises without
one) or with ``--device cpu``.

    python -m litepi_tpu_torch.apps.ablation --bench --output runs/ablation
"""

from __future__ import annotations

import argparse
import csv
import sys


def forward_gflops(model, imgsz: int, device) -> float:
    """GFLOPs of one (1, 3, imgsz, imgsz) float32 forward of ``model``
    (FlopCounterMode's count: the convolutions' 2 x multiply-adds)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.zeros((1, 3, imgsz, imgsz), device=device)
    counter = FlopCounterMode(display=False)
    with counter, torch.inference_mode():
        model(x)
    return counter.get_total_flops() / 1e9


def forward_fps(model, batch: int, imgsz: int, iters: int, device) -> float:
    """Frames per second of ``iters`` back-to-back float32 forwards at
    ``batch`` after one warm-up: CUDA events on the card, the host clock on
    the CPU."""
    import time

    import torch

    x = torch.zeros((batch, 3, imgsz, imgsz), device=device)
    with torch.inference_mode():
        model(x)  # warm-up: cuDNN's algorithm choice, allocations
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                model(x)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                model(x)
            seconds = time.perf_counter() - t0
    return batch * iters / seconds


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="width/depth ablation sweep (PyTorch port)")
    p.add_argument("--widths", default="0.5,0.75,1.0",
                   help="comma list of width scales (reference grid: 0.5,0.75,1.0)")
    p.add_argument("--depths", default="0.33",
                   help="comma list of depth scales (reference grid: 0.33)")
    p.add_argument("--extra", default="0.75:0.67",
                   help="extra (w:d) combos, comma-separated ('' = none; reference "
                   "adds 0.75:0.67)")
    p.add_argument("--num_classes", type=int, default=1)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--bench", action="store_true",
                   help="measure the forward's FPS per variant (batch --bench_batch)")
    p.add_argument("--bench_batch", type=int, default=32)
    p.add_argument("--bench_iters", type=int, default=10)
    p.add_argument("--train", action="store_true",
                   help="train each variant via apps/train_detector.py (requires "
                   "--images/--labels) and record best mAP@0.5")
    p.add_argument("--images", default=None)
    p.add_argument("--labels", default=None)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--train_args", default="",
                   help="extra args passed through to train_detector (space-split)")
    p.add_argument("--output", default="runs/ablation")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    if args.train and not (args.images and args.labels):
        print("error: --train requires --images and --labels", file=sys.stderr)
        return 2
    try:
        widths = [float(w) for w in args.widths.split(",") if w]
        depths = [float(d) for d in args.depths.split(",") if d]
        extra = [tuple(float(v) for v in combo.split(":"))
                 for combo in args.extra.split(",") if combo]
    except ValueError:
        print("error: --widths/--depths are comma lists of floats; --extra "
              "is 'w:d,w:d'", file=sys.stderr)
        return 2

    import json
    import os

    from litepi_tpu_torch.core.device import resolve_device
    from litepi_tpu_torch.core.types import ablation_configs
    from litepi_tpu_torch.models import YoloLitePi
    from litepi_tpu_torch.weights.seeded import seeded_state

    device = resolve_device(args.device)  # raises without a card
    os.makedirs(args.output, exist_ok=True)
    cfgs = ablation_configs(width_scales=tuple(widths), depth_scales=tuple(depths),
                            extra=tuple(extra), num_classes=args.num_classes)
    # the combo order ablation_configs builds
    combos = [(w, d) for d in depths for w in widths]
    combos += [c for c in extra if c not in combos]
    rows = []
    for cfg, (w, d) in zip(cfgs, combos):
        model = YoloLitePi(cfg)
        model.load_state_dict(seeded_state(model, seed=0))
        model = model.eval().to(device)
        # trainable parameters: flax's "params" (BatchNorm's statistics apart)
        params = sum(int(t.numel()) for t in model.parameters())
        gflops = forward_gflops(model, args.imgsz, device)
        fps = (forward_fps(model, args.bench_batch, args.imgsz, args.bench_iters, device)
               if args.bench else None)

        map50 = best_epoch = None
        if args.train:
            from litepi_tpu_torch.apps.train_detector import main as train_main

            run_dir = os.path.join(args.output, cfg.name)
            rc = train_main(
                ["--images", args.images, "--labels", args.labels,
                 # val defaults to the train set (the notebook's runs used
                 # Ultralytics' own split); --train_args overrides it (later
                 # occurrences win in argparse)
                 "--val_images", args.images, "--val_labels", args.labels,
                 "--num_classes", str(args.num_classes), "--imgsz", str(args.imgsz),
                 "--epochs", str(args.epochs), "--width_scale", str(w), "--depth_scale", str(d),
                 "--output", run_dir, "--device", args.device]
                + [a for a in args.train_args.split() if a])
            if rc != 0:
                print(f"error: training {cfg.name} failed (rc {rc})", file=sys.stderr)
                return rc
            with open(os.path.join(run_dir, "results.json")) as f:
                res = json.load(f)
            map50, best_epoch = res["best_map50"], res["best_epoch"]

        row = {
            "name": cfg.name,
            "width_scale": w,
            "depth_scale": d,
            "params": params,
            "gflops": round(gflops, 3),
            "fps": round(fps, 1) if fps is not None else "",
            "map50": map50 if map50 is not None else "",
            "best_epoch": best_epoch if best_epoch is not None else "",
        }
        rows.append(row)
        print(f"{cfg.name}: {params / 1e6:.2f}M params, {gflops:.2f} GFLOPs"
              + (f", {row['fps']} fps" if fps is not None else "")
              + (f", mAP50 {map50}" if map50 is not None else ""))

    out_csv = os.path.join(args.output, "ablation_results.csv")
    with open(out_csv, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    print(f"wrote {out_csv} ({len(rows)} variants)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
