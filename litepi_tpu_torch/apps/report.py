"""Results-analyzer CLI of the PyTorch port — the reference's ``viz.py`` as
a script, the JAX package's ``apps/report.py`` with its flags.

Loads an eval output directory (``comparison_summary.csv`` plus the
per-combination ``*_usage.csv`` / ``*_stages.csv`` side files the e2e CLI
writes) and emits every paper artifact: LaTeX table, FPS comparison,
accuracy/speed trade-off, latency breakdown, resource-utilisation figure
(ref viz.py:228-283) and the plain-text summary.  Without matplotlib the
figures are skipped (``bench/reporting.py``); the table and the summary are
written.  It runs on the host only.

    python -m litepi_tpu_torch.apps.report --input output_eval --output figures
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
from typing import Dict


def _load_side_csv(path: str) -> Dict[str, float]:
    """One-row CSV (header + values) -> {column: float}."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if len(rows) < 2:
        return {}
    out = {}
    for k, v in zip(rows[0], rows[1]):
        try:
            out[k] = float(v)
        except ValueError:
            pass
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Generate paper figures + tables")
    p.add_argument(
        "--input", required=True,
        help="eval output dir containing comparison_summary.csv",
    )
    p.add_argument("--output", default="figures")
    args = p.parse_args(argv)

    summary = os.path.join(args.input, "comparison_summary.csv")
    if not os.path.exists(summary):
        print(f"error: {summary} not found", file=sys.stderr)
        return 2

    from litepi_tpu_torch.bench.reporting import ResultsAnalyzer

    analyzer = ResultsAnalyzer(summary, args.output)

    usage: Dict[str, Dict[str, float]] = {}
    stage_ms: Dict[str, Dict[str, float]] = {}
    for combo in analyzer.df["model_combination"].unique():
        combo_dir = os.path.join(args.input, combo)
        u = os.path.join(combo_dir, f"{combo}_usage.csv")
        s = os.path.join(combo_dir, f"{combo}_stages.csv")
        if os.path.exists(u):
            row = _load_side_csv(u)
            if row:
                usage[combo] = row
        if os.path.exists(s):
            row = _load_side_csv(s)
            if row:
                stage_ms[combo] = row

    paths = analyzer.generate_all_figures(
        stage_ms=stage_ms or None, usage=usage or None
    )
    print(analyzer.generate_summary_report())
    for path in paths:
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
