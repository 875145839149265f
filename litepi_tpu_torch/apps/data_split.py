"""Test-subset builder of the PyTorch port (the JAX package's
``apps/data_split.py``; host only).

Re-creates the reference's ``data_split.ipynb`` capability (cell 0): copy the
first N image+label pairs from a source split into a test-subset directory,
creating **empty** label files for images without annotations (negative
images must still count in the eval denominator).

    python -m litepi_tpu_torch.apps.data_split --src_images S/images \\
        --src_labels S/labels --dst_images T/images --dst_labels T/labels --num 1000
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

from litepi_tpu_torch.evals.labels import IMAGE_EXTENSIONS


def build_subset(
    src_images: str,
    src_labels: str,
    dst_images: str,
    dst_labels: str,
    num: int = 1000,
) -> int:
    os.makedirs(dst_images, exist_ok=True)
    os.makedirs(dst_labels, exist_ok=True)
    files = sorted(
        f for f in os.listdir(src_images)
        if f.lower().endswith(IMAGE_EXTENSIONS)
    )[:num]
    for f in files:
        shutil.copy2(os.path.join(src_images, f), os.path.join(dst_images, f))
        stem = os.path.splitext(f)[0] + ".txt"
        src_lbl = os.path.join(src_labels, stem)
        dst_lbl = os.path.join(dst_labels, stem)
        if os.path.exists(src_lbl):
            shutil.copy2(src_lbl, dst_lbl)
        else:  # negative image: empty label file (data_split.ipynb cell 0)
            open(dst_lbl, "w").close()
    return len(files)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Build an eval test subset")
    p.add_argument("--src_images", required=True)
    p.add_argument("--src_labels", required=True)
    p.add_argument("--dst_images", required=True)
    p.add_argument("--dst_labels", required=True)
    p.add_argument("--num", type=int, default=1000)
    args = p.parse_args(argv)
    n = build_subset(
        args.src_images, args.src_labels, args.dst_images, args.dst_labels,
        args.num,
    )
    print(f"copied {n} image/label pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
