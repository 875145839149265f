"""Data-parallel serving on several cards: ``MeshServer`` over N ranks
against one card's ``run_fused`` on the same global batch.

    python -m litepi_tpu_torch.tools.mesh_serve [--ranks N] [--batch B]

Starts N ranks (``parallel/multiprocess.py::spawn_ranks``, one card each
over NCCL), each building the serving configuration at full
width (yolo_plus_v2 + ShuffleNetV2-91, 640x640 BGR frames, bfloat16, 64
candidates, 16 detections, crop_det_budget 8, cls_crop_budget 4*B) from
the same seed, and the same global batch of B frames.  Each rank times
``MeshServer.serve`` (its B/N rows, the budget's all-gather of the ranking
scores, the outputs' all-gather; CUDA events, back-to-back windows after
warm-up); rank 0 also times ``run_fused`` on the whole batch on its card
and compares the two outputs: discrete outputs' agreement and the floats'
largest difference (cuDNN may choose other algorithms at B/N than at B,
so bf16 floats need not be bit-equal).  Prints one JSON line.  Exits
non-zero without N visible cards.
"""

from __future__ import annotations

import argparse
import json
import sys

ITERS = 20  # calls per timing window
WINDOWS = 5


def rank_body(batch: int) -> dict:
    """One rank: the served outputs' check (rank 0) and the timings."""
    import torch

    from litepi_tpu_torch.core.types import NMSConfig, PipelineConfig
    from litepi_tpu_torch.parallel.mesh import make_mesh
    from litepi_tpu_torch.pipeline import TwoStagePipeline
    from litepi_tpu_torch.pipeline.serving import MeshServer
    from litepi_tpu_torch.tools.stage_split import cuda_ms_windows

    mesh = make_mesh(backend="cuda")
    cfg = PipelineConfig(nms=NMSConfig(max_candidates=64, max_detections=16),
                         input_color="bgr", crop_det_budget=8, cls_crop_budget=4 * batch)
    pipe = TwoStagePipeline.initialize(cfg, seed=0, dtype=torch.bfloat16, device=mesh.device)
    server = MeshServer(pipe, mesh)
    gen = torch.Generator().manual_seed(0)
    frames = torch.randint(0, 256, (batch, 640, 640, 3), generator=gen,
                           dtype=torch.uint8).to(mesh.device)
    out = server.serve(frames)
    result = {"rank": mesh.rank, "ranks": mesh.size}
    serve_ms = cuda_ms_windows(lambda: server.serve(frames), ITERS, WINDOWS)
    result["serve_ms_windows"] = serve_ms
    if mesh.rank == 0:
        want = pipe.run_fused(frames)
        exact = ("valid", "det_class_ids", "cls_labels")
        result["discrete_equal_share"] = {
            k: float((out[k] == want[k]).float().mean()) for k in exact}
        result["max_abs_diff"] = {
            k: float((out[k].double() - want[k].double()).abs().max())
            for k in want if k not in exact}
        result["run_fused_ms_windows"] = cuda_ms_windows(lambda: pipe.run_fused(frames),
                                                         ITERS, WINDOWS)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--batch", type=int, default=128)
    args = p.parse_args(argv)

    import torch

    from litepi_tpu_torch.kernels import build as kbuild
    from litepi_tpu_torch.parallel.multiprocess import spawn_ranks

    if torch.cuda.device_count() < args.ranks:
        print(f"error: {args.ranks} ranks need {args.ranks} visible CUDA devices; "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    kbuild.build()  # once, before the ranks load the libraries
    ranks = spawn_ranks("litepi_tpu_torch.tools.mesh_serve:rank_body", args.ranks,
                        {"batch": args.batch}, device="cuda", timeout=900.0)
    median = sorted(max(r["serve_ms_windows"][i] for r in ranks)
                    for i in range(WINDOWS))[WINDOWS // 2]
    fused = sorted(ranks[0]["run_fused_ms_windows"])[WINDOWS // 2]
    print(json.dumps({
        "ranks": args.ranks, "batch": args.batch,
        # a window ends when the slowest rank's does
        "serve_ms_per_batch": median, "serve_fps": args.batch / median * 1e3,
        "run_fused_ms_per_batch_one_card": fused, "run_fused_fps": args.batch / fused * 1e3,
        "discrete_equal_share": ranks[0]["discrete_equal_share"],
        "max_abs_diff": ranks[0]["max_abs_diff"],
        "per_rank_serve_ms_windows": [r["serve_ms_windows"] for r in ranks],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
