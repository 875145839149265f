"""Dataset integrity audit CLI of the PyTorch port (the reference's
pre-training pairing checks, train-yolo-custom-tt100k.ipynb cell 6 /
revision-ablation-study.ipynb cell 3; host only).

    python -m litepi_tpu_torch.apps.data_audit \
        --images data/images --labels data/labels --num_classes 1

Exit code 0 when clean (negatives are allowed), 1 when problems are found.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Audit a YOLO-format dataset")
    p.add_argument("--images", required=True)
    p.add_argument("--labels", required=True)
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument(
        "--skip_decode", action="store_true",
        help="skip the (slow) image-readability check",
    )
    args = p.parse_args(argv)

    from litepi_tpu_torch.data.audit import audit_dataset, format_report

    report = audit_dataset(
        args.images,
        args.labels,
        num_classes=args.num_classes,
        check_readable=not args.skip_decode,
    )
    print(format_report(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
