"""Data-parallel runs across N cards over NCCL, one rank per card: the
1-vs-N-rank flow, and the detector training CLI's time per epoch at 1, 2,
... N ranks beside its host data pipeline's.

    python -m litepi_tpu_torch.tools.dp_cards [--ranks N]

First ``parallel/multiprocess.py::run_multiprocess_dryrun(N)`` over NCCL
(shard coverage, one float32 train step on the global batch,
``MeshServer.serve_local`` with a classifier budget that binds, the
checkpoint swap; at 1 rank and at N ranks, raising where they disagree
beyond its bounds): the two runs' loss and parameter checksum and the
served floats' largest difference.  Then ``apps/train_detector.py`` as a
user runs it (bf16, 640, global ``--batch 16``, its augmentation
defaults) on IMAGES synthetic 640x480 JPEGs for EPOCHS epochs at every
rank count that is a power of two up to N: seconds per epoch from the CLI's own
lines (validation apart; the last epoch is past cuDNN's warm-up).  Beside
them, the host data pipeline alone in one process
(``DetectionDataset.batches`` at the global batch, the CLI's settings):
with one host every rank decodes and augments the whole global batch and
keeps its rows, so an epoch cannot take less than that pipeline's time,
whatever N.  Prints one JSON line.  Exits non-zero without N visible
cards.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

GLOBAL_BATCH = 16  # the reference's training batch (imgsz 640)
IMAGES = 256  # 16 steps per epoch
EPOCHS = 2  # the last one past cuDNN's warm-up
FRAME = (480, 640)  # the synthetic JPEGs' height, width
EPOCH_LINE = re.compile(r"epoch (\d+)/\d+  loss (\S+)  .*\((\S+)s, validation (\S+)s\)")


def write_images(root: str, n: int, rng) -> tuple:
    """``n`` 640x480 JPEGs with 1 to 3 bright boxes each and their YOLO
    labels (class 0) under ``root``/images and ``root``/labels, drawn from
    the numpy generator ``rng``."""
    import cv2
    import numpy as np

    img_dir, lbl_dir = os.path.join(root, "images"), os.path.join(root, "labels")
    os.makedirs(img_dir)
    os.makedirs(lbl_dir)
    h, w = FRAME
    for i in range(n):
        img = rng.integers(0, 120, (h, w, 3), dtype=np.uint8)
        lines = []
        for _ in range(int(rng.integers(1, 4))):
            bw, bh = (int(v) for v in rng.integers(24, 96, 2))
            x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            img[y : y + bh, x : x + bw] = rng.integers(180, 256, 3, dtype=np.uint8)
            lines.append(f"0 {(x + bw / 2) / w:.6f} {(y + bh / 2) / h:.6f} {bw / w:.6f} "
                         f"{bh / h:.6f}\n")
        cv2.imwrite(os.path.join(img_dir, f"f{i:03d}.jpg"), img)
        with open(os.path.join(lbl_dir, f"f{i:03d}.txt"), "w") as f:
            f.writelines(lines)
    return img_dir, lbl_dir


def data_seconds_per_batch(img_dir: str, lbl_dir: str, steps: int) -> float:
    """The CLI's host data pipeline alone, one process: seconds per global
    batch over ``steps`` batches of epoch 0."""
    from litepi_tpu_torch.apps.train_detector import build_arg_parser
    from litepi_tpu_torch.data.dataset import DetectionDataset

    a = build_arg_parser().parse_args(["--images", img_dir, "--labels", lbl_dir])
    dataset = DetectionDataset(img_dir, lbl_dir, input_size=a.imgsz, max_gt=a.max_gt,
                               mosaic_p=a.mosaic, scale=a.scale, seed=a.seed)
    dataset.seed_epoch(0)
    t0 = time.perf_counter()
    for _ in dataset.batches(GLOBAL_BATCH, steps):
        pass
    return (time.perf_counter() - t0) / steps


def cli_epochs(img_dir: str, lbl_dir: str, out: str, ranks: int, epochs: int) -> list:
    """``apps/train_detector.py --data_parallel ranks`` in its own process;
    the epochs' (loss, seconds, validation seconds) from its lines."""
    argv = [sys.executable, "-m", "litepi_tpu_torch.apps.train_detector", "--images", img_dir,
            "--labels", lbl_dir, "--batch", str(GLOBAL_BATCH), "--epochs", str(epochs),
            "--patience", "99", "--output", out, "--data_parallel", str(ranks)]
    run = subprocess.run(argv, capture_output=True, text=True, timeout=1200)
    if run.returncode != 0:
        raise RuntimeError(f"train_detector --data_parallel {ranks}: rc {run.returncode}\n"
                           f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    rows = [dict(epoch=int(e), loss=float(loss), seconds=float(s), validation_s=float(v))
            for e, loss, s, v in EPOCH_LINE.findall(run.stdout)]
    if len(rows) != epochs:
        raise RuntimeError(f"train_detector --data_parallel {ranks}: epoch lines {rows}\n"
                           f"{run.stdout[-3000:]}")
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=4)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from litepi_tpu_torch.kernels import build as kbuild
    from litepi_tpu_torch.parallel.multiprocess import run_multiprocess_dryrun

    if torch.cuda.device_count() < args.ranks:
        print(f"error: {args.ranks} ranks need {args.ranks} visible CUDA devices; "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    kbuild.build()  # once, before the ranks load the libraries
    result = {"ranks": args.ranks, "cards": [torch.cuda.get_device_name(i)
                                             for i in range(args.ranks)]}
    t0 = time.perf_counter()
    flow = run_multiprocess_dryrun(args.ranks, device="cuda", timeout=900.0)
    single, multi = flow["single"], flow["multi"]
    result["flow"] = dict(
        seconds=time.perf_counter() - t0,
        loss={"1": single["loss"], str(args.ranks): multi["loss"]},
        param_sum={"1": single["param_sum"], str(args.ranks): multi["param_sum"]},
        served_max_abs_diff={k: float(abs(single["served"][k].astype("float64")
                                          - multi["served"][k]).max())
                             for k in ("boxes", "det_scores", "cls_probs", "cls_scores")})
    print(f"flow at {args.ranks} NCCL ranks vs 1: {json.dumps(result['flow'])}", flush=True)

    steps = IMAGES // GLOBAL_BATCH
    with tempfile.TemporaryDirectory(prefix="litepi_dp_cards_") as root:
        img_dir, lbl_dir = write_images(os.path.join(root, "data"), IMAGES,
                                        np.random.default_rng(0))
        result["data_s_per_global_batch"] = data_seconds_per_batch(img_dir, lbl_dir, steps)
        result["steps_per_epoch"] = steps
        result["cli"] = {}
        n = 1
        while n <= args.ranks:
            rows = cli_epochs(img_dir, lbl_dir, os.path.join(root, f"out{n}"), n, EPOCHS)
            result["cli"][str(n)] = dict(epochs=rows,
                                         ms_per_step=rows[-1]["seconds"] / steps * 1e3)
            print(f"train_detector --data_parallel {n}: {json.dumps(rows)}", flush=True)
            n *= 2
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
