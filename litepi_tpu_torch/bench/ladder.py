"""Multi-level optimisation experiment of the PyTorch port — the reference's
``runner.py`` story, the JAX package's ``bench/ladder.py`` with its names
and levels, on one CUDA card.

The reference's ladder (reference: src/vntsr/pipeline/runner.py:271-705):
L0 plain compile -> L1 model choice -> L2 runtime hints + pre-bound tensors +
batch-4 classify -> L3 efficient NMS + memory pooling + batch 8 -> L4 cpu
governor + batch 16.  Those knobs are CPU-engine concepts; the equivalent
levers on an accelerator are program structure and batching:

=====  ==============================================================
L0     staged programs, batch 1, float32 — the naive per-image port
L1     model choice (smaller classifier), still batch 1
L2     batched staged programs (batch 8), bfloat16 compute
L3     fused single program (detect->NMS->crop->classify), batch 8
L4     fused program, large batch (64), serving detection budget
=====  ==============================================================

Every level runs the REAL pipeline on real decoded frames: staged levels go
through :meth:`PipelineEvaluator.run_images` (host letterbox -> device
detect (the NMS kernel) -> host ROI crops -> device classify — the
reference's HybridPipeline structure), fused levels through
:meth:`TwoStagePipeline.run_fused` (the stem, NMS and ROI kernels on
canvas-sized frames).  Each level reports mean/P50/P95/P99
latency, FPS, AND accuracy (detection mAP50 / precision / recall vs the
dataset's ground truth, mirroring the reference's per-level
``_compute_accuracy``, runner.py:348-370) so speedups that trade quality
(e.g. L4's serving budget) are visible.  A comparison report + LaTeX rows
follow (runner.py:937-1008).  Latency is the host clock around a batch
that ends with its results on the host.  The experiment runs on the card
(``device="cuda"``, the default; it raises without one) or on the CPU.

    python -m litepi_tpu_torch.bench.ladder [--levels N] [--images I --labels L]
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from litepi_tpu_torch.core.device import resolve_device
from litepi_tpu_torch.core.metrics import percentile_summary
from litepi_tpu_torch.core.types import PipelineConfig
from litepi_tpu_torch.evals.reference import evaluate_predictions_reference
from litepi_tpu_torch.pipeline.evaluator import PipelineEvaluator
from litepi_tpu_torch.pipeline.two_stage import TwoStagePipeline


@dataclasses.dataclass
class LevelSpec:
    name: str
    description: str
    batch: int
    fused: bool
    dtype: str = "bfloat16"
    classifier: str = "shufflenetv2"
    max_detections: int = 64


LEVELS: List[LevelSpec] = [
    LevelSpec(
        "Level 0", "staged per-image float32 (naive port)", 1, False, "float32"
    ),
    LevelSpec("Level 1", "model choice: lightest classifier", 1, False, "float32"),
    LevelSpec("Level 2", "batched staged programs + bfloat16", 8, False),
    LevelSpec("Level 3", "fused single program batch 8", 8, True),
    LevelSpec(
        "Level 4", "fused batch 64 serving budget", 64, True, max_detections=16
    ),
]


def make_synthetic_dataset(
    n: int = 16,
    hw: Tuple[int, int] = (640, 640),
    signs_per_image: int = 3,
    seed: int = 0,
) -> Tuple[np.ndarray, List[Tuple[np.ndarray, np.ndarray]]]:
    """Fixed synthetic scene set with ground truth: textured background plus
    bright painted 'signs' (axis-aligned boxes).  Accuracy numbers on random
    weights will be ~0 — the point is a *fixed, labelled* input set so level
    accuracy is comparable, matching the reference's use of a fixed 50-image
    sample (runner.py:739-792)."""
    h, w = hw
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 110, (n, h, w, 3), dtype=np.uint8)
    gts = []
    for i in range(n):
        boxes = []
        for _ in range(signs_per_image):
            bw, bh = rng.integers(30, 90, 2)
            x = int(rng.integers(0, w - bw))
            y = int(rng.integers(0, h - bh))
            colour = rng.integers(180, 256, 3)
            frames[i, y : y + bh, x : x + bw] = colour
            boxes.append([x, y, x + bw, y + bh])
        gts.append(
            (
                np.asarray(boxes, np.float32),
                np.zeros(len(boxes), np.int64),
            )
        )
    return frames, gts


class OptimizationExperiment:
    """Lazy per-level pipelines + measurement loops (the reference's
    ``OptimizationExperiment``, runner.py:710-928)."""

    def __init__(
        self,
        base_cfg: Optional[PipelineConfig] = None,
        levels: Optional[List[LevelSpec]] = None,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        # ladder frames are cv2-BGR (real images via imread; synthetic
        # frames are colour-order agnostic) — compute in RGB
        self.base_cfg = base_cfg or PipelineConfig(input_color="bgr")
        self.levels = levels if levels is not None else LEVELS
        self._pipes: Dict[str, TwoStagePipeline] = {}
        self.results: Dict[str, Dict[str, float]] = {}
        self._frames: Optional[np.ndarray] = None
        self._gts: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None

    # ------------------------------------------------------------------ #
    # dataset                                                             #
    # ------------------------------------------------------------------ #

    def use_synthetic_dataset(self, n: int = 16, seed: int = 0) -> None:
        hw = (self.base_cfg.det_input_size, self.base_cfg.det_input_size)
        self._frames, self._gts = make_synthetic_dataset(n, hw, seed=seed)

    def load_test_dataset(
        self,
        images_dir: str,
        labels_dir: Optional[str] = None,
        max_images: int = 50,
    ) -> int:
        """Preload up to ``max_images`` same-resolution images (+ YOLO labels
        when given) into RAM — the reference preloads its sample the same way
        (runner.py:739-792).  Returns the number loaded."""
        import cv2

        from litepi_tpu_torch.evals.labels import parse_yolo_label, sample_images

        paths = sample_images(images_dir, max_images, seed=42)
        frames, gts, shape = [], [], None
        unreadable = mixed_res = 0
        for p in paths:
            img = cv2.imread(p)
            if img is None:
                unreadable += 1
                continue
            if shape is None:
                shape = img.shape
            elif img.shape != shape:
                # fused program needs one resolution per batch
                mixed_res += 1
                continue
            frames.append(img)
            if labels_dir:
                lp = os.path.join(
                    labels_dir,
                    os.path.splitext(os.path.basename(p))[0] + ".txt",
                )
                b, c = parse_yolo_label(lp, img.shape[1], img.shape[0])
                gts.append((b, c.astype(np.int64)))
            else:
                gts.append(
                    (np.zeros((0, 4), np.float32), np.zeros(0, np.int64))
                )
        if not frames:
            raise ValueError(f"no readable images in {images_dir}")
        if unreadable or mixed_res:
            # no silent caps: the accuracy sample must be an announced set
            print(
                f"ladder dataset: kept {len(frames)}/{len(paths)} images "
                f"({unreadable} unreadable, {mixed_res} dropped for "
                f"resolution != {shape[1]}x{shape[0]})"
            )
        self._frames = np.stack(frames)
        self._gts = gts
        return len(frames)

    def _dataset(self) -> Tuple[np.ndarray, List]:
        if self._frames is None:
            self.use_synthetic_dataset()
        return self._frames, self._gts

    # ------------------------------------------------------------------ #
    # per-level pipeline                                                  #
    # ------------------------------------------------------------------ #

    def _get_pipeline(self, spec: LevelSpec) -> TwoStagePipeline:
        key = f"{spec.dtype}-{spec.classifier}-{spec.max_detections}"
        if key not in self._pipes:
            cfg = dataclasses.replace(
                self.base_cfg,
                classifier_arch=spec.classifier,
                nms=dataclasses.replace(
                    self.base_cfg.nms, max_detections=spec.max_detections
                ),
            )
            dtype = torch.bfloat16 if spec.dtype == "bfloat16" else torch.float32
            self._pipes[key] = TwoStagePipeline.initialize(cfg, dtype=dtype,
                                                           device=self.device)
        return self._pipes[key]

    def _run_once(
        self,
        pipe: TwoStagePipeline,
        evaluator: PipelineEvaluator,
        spec: LevelSpec,
        frames: np.ndarray,
    ) -> List[Dict[str, np.ndarray]]:
        """One real pipeline pass over ``frames``; returns per-image result
        dicts (boxes in original pixels, det_scores), on the host."""
        if spec.fused:
            out = pipe.run_fused(frames, 0.25)
            valid = out["valid"].cpu().numpy()
            boxes, scores = out["boxes"].cpu().numpy(), out["det_scores"].cpu().numpy()
            return [{"boxes": boxes[bi][valid[bi]], "det_scores": scores[bi][valid[bi]]}
                    for bi in range(len(frames))]
        # staged: host letterbox -> device detect -> host ROI -> device
        # classify — the reference's HybridPipeline structure on real frames
        return evaluator.run_images(list(frames), 0.25)

    # ------------------------------------------------------------------ #
    # measurement                                                         #
    # ------------------------------------------------------------------ #

    def run_single_level(
        self,
        spec: LevelSpec,
        warmup: int = 3,
        iterations: int = 10,
    ) -> Dict[str, float]:
        frames, gts = self._dataset()
        n = len(frames)
        pipe = self._get_pipeline(spec)
        evaluator = PipelineEvaluator(pipe)

        def batch_at(i: int) -> np.ndarray:
            idx = (np.arange(spec.batch) + i * spec.batch) % n
            return frames[idx]

        for i in range(warmup):
            self._run_once(pipe, evaluator, spec, batch_at(i))
        lat = []
        for i in range(iterations):
            t0 = time.perf_counter()
            self._run_once(pipe, evaluator, spec, batch_at(i))
            lat.append((time.perf_counter() - t0) * 1e3)

        # accuracy pass: one full cycle over the labelled set at the same
        # operating point (detection-level, like runner.py:348-370)
        preds = []
        for start in range(0, n, spec.batch):
            idx = np.arange(start, min(start + spec.batch, n))
            pad = spec.batch - len(idx)
            batch = frames[np.concatenate([idx, idx[-1:].repeat(pad)])]
            results = self._run_once(pipe, evaluator, spec, batch)
            for res in results[: len(idx)]:
                preds.append(
                    (
                        res["boxes"],
                        res["det_scores"],
                        np.zeros(len(res["boxes"]), np.int64),
                    )
                )
        # detection-level accuracy (runner.py:348-370): the detector is
        # 1-class ("sign"), so GT class ids are collapsed to 0 — otherwise
        # every non-0-class GT in a multi-class label dir would be
        # unmatched by construction and deflate mAP (train_detector.py's
        # validate() applies the same collapse).
        gts_det = [(gb, np.zeros_like(gc)) for gb, gc in gts]
        acc = evaluate_predictions_reference(preds, gts_det, num_classes=1)

        stats = percentile_summary(lat)
        stats["fps"] = spec.batch / (stats["mean"] / 1e3)
        stats["batch"] = spec.batch
        stats["mAP50"] = float(acc["mAP50"])
        stats["precision"] = float(acc["mean_precision"])
        stats["recall"] = float(acc["mean_recall"])
        self.results[spec.name] = stats
        self._print_level_summary(spec, stats)
        return stats

    def run_all_levels(self, **kw) -> Dict[str, Dict[str, float]]:
        for spec in self.levels:
            self.run_single_level(spec, **kw)
        return self.results

    @staticmethod
    def _print_level_summary(spec: LevelSpec, s: Dict[str, float]) -> None:
        print(
            f"{spec.name} ({spec.description}): "
            f"fps={s['fps']:.1f} mean={s['mean']:.1f}ms "
            f"p50={s['p50']:.1f} p95={s['p95']:.1f} p99={s['p99']:.1f} "
            f"mAP50={s['mAP50']:.3f} P={s['precision']:.3f} "
            f"R={s['recall']:.3f}"
        )

    def generate_comparison_report(self) -> str:
        if not self.results:
            return "(no results)"
        base = next(iter(self.results.values()))["fps"]
        lines = [
            # timing_caveat: staged (unfused) levels round-trip to the
            # host between their stages (letterbox, crops); fused levels
            # issue one program per batch
            "level,description,batch,fps,mean_ms,p50_ms,p95_ms,p99_ms,"
            "speedup_vs_L0,mAP50,precision,recall,timing_caveat"
        ]
        for spec in self.levels:
            if spec.name not in self.results:
                continue
            s = self.results[spec.name]
            caveat = (
                "host round trips between stages"
                if not spec.fused
                else "one fused program per batch"
            )
            lines.append(
                f"{spec.name},{spec.description},{s['batch']},"
                f"{s['fps']:.2f},{s['mean']:.2f},{s['p50']:.2f},"
                f"{s['p95']:.2f},{s['p99']:.2f},{s['fps'] / base:.2f},"
                f"{s['mAP50']:.4f},{s['precision']:.4f},{s['recall']:.4f},"
                f"{caveat}"
            )
        return "\n".join(lines)

    def plot_optimization_progress(self, path: str) -> Optional[str]:
        """2x2 progress figure: latency / FPS bars, accuracy bars, and a
        cumulative-speedup line (the reference's
        ``plot_optimization_progress``, runner.py:1010-1109, with mAP50 in
        place of its TP/FP-derived scores).  Returns the written path, or
        None without matplotlib."""
        if not self.results:
            return None
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:  # pragma: no cover - matplotlib is optional
            return None

        specs = [s for s in self.levels if s.name in self.results]
        stats = [self.results[s.name] for s in specs]
        # label by the level's REAL identity, not its position, so partial
        # runs (a missing level) don't mislabel the bars
        ticks = [s.name.replace("Level ", "L") for s in specs]
        x = np.arange(len(specs))

        fig, axes = plt.subplots(2, 2, figsize=(14, 10))
        fig.suptitle(
            "Multi-Level Optimisation Results (CUDA)", fontsize=16,
            fontweight="bold",
        )

        ax = axes[0, 0]
        ax.bar(x, [s["mean"] for s in stats], alpha=0.7, edgecolor="black")
        ax.set_xticks(x, ticks)
        ax.set_xlabel("Optimisation level")
        ax.set_ylabel("Latency (ms)")
        ax.set_title("End-to-end batch latency")
        ax.grid(axis="y", alpha=0.3)

        ax = axes[0, 1]
        ax.bar(x, [s["fps"] for s in stats], alpha=0.7, edgecolor="black")
        ax.set_xticks(x, ticks)
        ax.set_xlabel("Optimisation level")
        ax.set_ylabel("FPS")
        ax.set_title("Throughput")
        ax.grid(axis="y", alpha=0.3)

        ax = axes[1, 0]
        width = 0.25
        ax.bar(x - width, [s["precision"] for s in stats], width,
               label="Precision", alpha=0.7)
        ax.bar(x, [s["recall"] for s in stats], width, label="Recall",
               alpha=0.7)
        ax.bar(x + width, [s["mAP50"] for s in stats], width, label="mAP50",
               alpha=0.7)
        ax.set_xticks(x, ticks)
        ax.set_xlabel("Optimisation level")
        ax.set_ylabel("Score")
        ax.set_title("Detection accuracy")
        ax.legend()
        ax.grid(axis="y", alpha=0.3)

        ax = axes[1, 1]
        # baseline = the first level PRESENT (titled accordingly)
        base = stats[0]["fps"] or 1.0
        speedups = [s["fps"] / base for s in stats]
        ax.plot(x, speedups, marker="o", linewidth=2, markersize=8)
        ax.fill_between(x, speedups, alpha=0.3)
        for i, v in enumerate(speedups):
            ax.annotate(
                f"{v:.2f}x", (i, v), textcoords="offset points",
                xytext=(0, 10), ha="center", fontweight="bold",
            )
        ax.set_xticks(x, ticks)
        ax.set_xlabel("Optimisation level")
        ax.set_ylabel("Speedup factor")
        ax.set_title(f"Cumulative speedup vs {ticks[0]}")
        ax.grid(True, alpha=0.3)

        fig.tight_layout()
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return path

    def generate_latex(self) -> str:
        rows = [
            "\\begin{tabular}{llrrrr}",
            "\\hline",
            "Level & Optimisation & Batch & FPS & P95 (ms) & mAP50 \\\\",
            "\\hline",
        ]
        for spec in self.levels:
            if spec.name not in self.results:
                continue
            s = self.results[spec.name]
            rows.append(
                f"{spec.name} & {spec.description} & {s['batch']} & "
                f"{s['fps']:.1f} & {s['p95']:.1f} & {s['mAP50']:.3f} \\\\"
            )
        rows += ["\\hline", "\\end{tabular}"]
        return "\n".join(rows)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Optimisation-ladder experiment (PyTorch port)")
    p.add_argument("--iterations", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--levels", type=int, default=None, help="run first N levels")
    p.add_argument("--images", default=None, help="labelled image dir (else synthetic)")
    p.add_argument("--labels", default=None, help="YOLO label dir for --images")
    p.add_argument("--max_images", type=int, default=50)
    p.add_argument("--output", default=None, help="write CSV report here")
    p.add_argument(
        "--plot", default=None, metavar="PNG",
        help="write the 2x2 optimisation-progress figure here",
    )
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    exp = OptimizationExperiment(
        levels=LEVELS[: args.levels] if args.levels else None, device=args.device
    )
    if args.images:
        n = exp.load_test_dataset(args.images, args.labels, args.max_images)
        print(f"loaded {n} images from {args.images}")
    exp.run_all_levels(warmup=args.warmup, iterations=args.iterations)
    report = exp.generate_comparison_report()
    print(report)
    if args.output:
        with open(args.output, "w") as f:
            f.write(report + "\n")
    if args.plot:
        written = exp.plot_optimization_progress(args.plot)
        print(f"progress figure: {written or 'skipped (no matplotlib)'}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
