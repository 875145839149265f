"""Results analysis and paper-artifact generation of the PyTorch port, the
JAX package's ``bench/reporting.py`` with its names.

Re-creates the reference's ``viz.py`` ``ResultsAnalyzer`` capability
(reference: src/tt100k/pipeline/viz.py:18-493): load result CSVs, emit a
LaTeX comparison table (:36-97), latency-breakdown / accuracy-speed /
FPS-comparison / latency-distribution figures (:99-395) and a text summary
report (:410-462).  Inputs are the ``comparison_summary.csv`` files the
port's evaluator writes (the reference's schema) plus optional per-batch
latency samples.

pandas is imported here, matplotlib inside each figure function: without
matplotlib (the card's machine has none) a figure function draws nothing
and returns None, and :meth:`ResultsAnalyzer.generate_all_figures` returns
the figures it drew; the LaTeX table and the summary are written either
way.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import pandas as pd


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


class ResultsAnalyzer:
    def __init__(self, summary_csv: str, output_dir: str = "figures") -> None:
        self.df = self.load_results(summary_csv)
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)

    @staticmethod
    def load_results(summary_csv: str) -> pd.DataFrame:
        df = pd.read_csv(summary_csv)
        # the reference appends a header-less warmup row sometimes; drop rows
        # with no images evaluated
        df = df[pd.to_numeric(df["num_test_images"], errors="coerce") > 0]
        return df.reset_index(drop=True)

    # ----------------------------------------------------------------- #

    def generate_latex_table(self, caption: str = "Pipeline comparison") -> str:
        """LaTeX comparison table (the reference's Table 4.6 generator,
        viz.py:36-97)."""
        lines = [
            "\\begin{table}[h]",
            "\\centering",
            f"\\caption{{{caption}}}",
            "\\begin{tabular}{lrrrrr}",
            "\\hline",
            "Pipeline & FPS & Precision & Recall & mAP@0.5 & mAP@0.5:0.95 \\\\",
            "\\hline",
        ]
        for _, r in self.df.iterrows():
            name = str(r["model_combination"]).replace("_", "\\_")
            lines.append(
                f"{name} & {float(r['fps']):.2f} & "
                f"{float(r['mean_precision']):.3f} & {float(r['mean_recall']):.3f} & "
                f"{float(r['mAP50']):.4f} & {float(r['mAP50-95']):.4f} \\\\"
            )
        lines += ["\\hline", "\\end{tabular}", "\\end{table}"]
        tex = "\n".join(lines)
        with open(os.path.join(self.output_dir, "comparison_table.tex"), "w") as f:
            f.write(tex)
        return tex

    def plot_fps_comparison(self) -> Optional[str]:
        """Bar chart of e2e FPS per pipeline (viz.py:330-395)."""
        plt = _pyplot()
        if plt is None:
            return None

        fig, ax = plt.subplots(figsize=(8, 4.5))
        names = self.df["model_combination"]
        ax.bar(names, self.df["fps"].astype(float), color="#4878a8")
        ax.set_ylabel("end-to-end FPS")
        ax.set_title("Pipeline throughput")
        ax.tick_params(axis="x", rotation=30)
        fig.tight_layout()
        path = os.path.join(self.output_dir, "fps_comparison.png")
        fig.savefig(path, dpi=150)
        plt.close(fig)
        return path

    def plot_accuracy_speed_tradeoff(self) -> Optional[str]:
        """mAP@0.5 vs FPS scatter (viz.py:155-227)."""
        plt = _pyplot()
        if plt is None:
            return None

        fig, ax = plt.subplots(figsize=(7, 5))
        ax.scatter(
            self.df["fps"].astype(float),
            self.df["mAP50"].astype(float),
            s=60,
            color="#a85448",
        )
        for _, r in self.df.iterrows():
            ax.annotate(
                r["model_combination"],
                (float(r["fps"]), float(r["mAP50"])),
                fontsize=8,
                xytext=(4, 4),
                textcoords="offset points",
            )
        ax.set_xlabel("FPS")
        ax.set_ylabel("mAP@0.5")
        ax.set_title("Accuracy / speed trade-off")
        fig.tight_layout()
        path = os.path.join(self.output_dir, "accuracy_speed.png")
        fig.savefig(path, dpi=150)
        plt.close(fig)
        return path

    def plot_latency_breakdown(
        self, stage_ms: Dict[str, Dict[str, float]]
    ) -> Optional[str]:
        """Stacked per-stage latency bars (viz.py:99-153).  ``stage_ms``:
        {pipeline_name: {stage: ms}}."""
        plt = _pyplot()
        if plt is None:
            return None

        stages = sorted({s for v in stage_ms.values() for s in v})
        names = list(stage_ms)
        bottom = np.zeros(len(names))
        fig, ax = plt.subplots(figsize=(8, 4.5))
        for stage in stages:
            vals = np.array([stage_ms[n].get(stage, 0.0) for n in names])
            ax.bar(names, vals, bottom=bottom, label=stage)
            bottom += vals
        ax.set_ylabel("ms per batch")
        ax.set_title("Per-stage latency breakdown")
        ax.legend()
        ax.tick_params(axis="x", rotation=30)
        fig.tight_layout()
        path = os.path.join(self.output_dir, "latency_breakdown.png")
        fig.savefig(path, dpi=150)
        plt.close(fig)
        return path

    def plot_latency_distribution(
        self, samples_ms: Dict[str, Sequence[float]]
    ) -> Optional[str]:
        """Latency box plots (viz.py:285-328)."""
        plt = _pyplot()
        if plt is None:
            return None

        fig, ax = plt.subplots(figsize=(8, 4.5))
        names = list(samples_ms)
        ax.boxplot([samples_ms[n] for n in names], tick_labels=names)
        ax.set_ylabel("latency ms")
        ax.set_title("Latency distribution")
        ax.tick_params(axis="x", rotation=30)
        fig.tight_layout()
        path = os.path.join(self.output_dir, "latency_distribution.png")
        fig.savefig(path, dpi=150)
        plt.close(fig)
        return path

    def plot_resource_utilization(
        self, usage: Dict[str, Dict[str, float]]
    ) -> Optional[str]:
        """CPU% / RSS bars per pipeline (viz.py:228-283).  ``usage``:
        {pipeline_name: {"cpu_percent": x, "memory_mb": y}} — the counters
        the evaluator collects via core.metrics.read_host_counters."""
        plt = _pyplot()
        if plt is None:
            return None

        names = list(usage)
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        axes[0].bar(
            names, [usage[n].get("cpu_percent", 0.0) for n in names],
            color="#4878a8",
        )
        axes[0].set_ylabel("CPU %")
        axes[1].bar(
            names, [usage[n].get("memory_mb", 0.0) for n in names],
            color="#a85448",
        )
        axes[1].set_ylabel("RSS MB")
        for ax in axes:
            ax.tick_params(axis="x", rotation=30)
        fig.suptitle("Host resource utilisation")
        fig.tight_layout()
        path = os.path.join(self.output_dir, "resource_utilization.png")
        fig.savefig(path, dpi=150)
        plt.close(fig)
        return path

    def generate_summary_report(self) -> str:
        """Plain-text summary (viz.py:410-462)."""
        lines = ["=" * 60, "PIPELINE COMPARISON SUMMARY", "=" * 60]
        best_fps = self.df.loc[self.df["fps"].astype(float).idxmax()]
        best_map = self.df.loc[self.df["mAP50"].astype(float).idxmax()]
        lines.append(
            f"fastest: {best_fps['model_combination']} @ {float(best_fps['fps']):.2f} FPS"
        )
        lines.append(
            f"most accurate: {best_map['model_combination']} @ mAP50 {float(best_map['mAP50']):.4f}"
        )
        lines.append("-" * 60)
        for _, r in self.df.iterrows():
            lines.append(
                f"{r['model_combination']:<40} fps={float(r['fps']):>8.2f} "
                f"mAP50={float(r['mAP50']):.4f} mAP50-95={float(r['mAP50-95']):.4f}"
            )
        report = "\n".join(lines)
        with open(os.path.join(self.output_dir, "summary_report.txt"), "w") as f:
            f.write(report)
        return report

    def generate_all_figures(
        self,
        stage_ms: Optional[Dict[str, Dict[str, float]]] = None,
        samples_ms: Optional[Dict[str, Sequence[float]]] = None,
        usage: Optional[Dict[str, Dict[str, float]]] = None,
    ) -> List[str]:
        """Every figure the inputs allow (the paths drawn; none without
        matplotlib), the LaTeX table and the summary report."""
        out = [
            self.plot_fps_comparison(),
            self.plot_accuracy_speed_tradeoff(),
        ]
        if stage_ms:
            out.append(self.plot_latency_breakdown(stage_ms))
        if samples_ms:
            out.append(self.plot_latency_distribution(samples_ms))
        if usage:
            out.append(self.plot_resource_utilization(usage))
        self.generate_latex_table()
        self.generate_summary_report()
        return [p for p in out if p is not None]
