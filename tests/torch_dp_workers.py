"""Rank bodies of the port's data-parallel tests (``tests/test_torch_*``).

Each function runs inside one rank that ``litepi_tpu_torch.parallel.
multiprocess.spawn_ranks`` starts (gloo, on the CPU) and returns numpy
results to the test, which holds them against the JAX package in its own
process.  This module imports the port, torch and numpy only: the ranks
never load JAX.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from litepi_tpu_torch.parallel.mesh import make_mesh

SERVE_KEYS = ("boxes", "det_scores", "det_class_ids", "valid", "cls_probs", "cls_labels",
              "cls_scores")


def _numpy(out):
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def _pipeline(cfg, det_vars, cls_vars):
    from litepi_tpu_torch.pipeline import TwoStagePipeline

    return TwoStagePipeline.from_jax_vars(cfg, det_vars, cls_vars, device="cpu")


def serve(cfg, det_vars, cls_vars, frames, conf):
    """``MeshServer.serve`` on the global batch ``frames``, then the
    indivisible batch's error, then ``serve_local`` + ``gather`` on this
    rank's rows."""
    from litepi_tpu_torch.parallel.mesh import batch_sharding
    from litepi_tpu_torch.pipeline.serving import MeshServer

    mesh = make_mesh(backend="cpu")
    server = MeshServer(_pipeline(cfg, det_vars, cls_vars), mesh)
    out = _numpy(server.serve(frames, conf))
    try:
        server.serve(frames[:-1], conf)
        error = None
    except ValueError as e:
        error = str(e)
    local = frames[batch_sharding(mesh).rows(frames.shape[0])]
    gathered = _numpy(server.gather(server.serve_local(local, conf)))
    return {"served": out, "local_gathered": gathered, "indivisible": error,
            "data_parallelism": server.data_parallelism}


class _MemoryRunner:
    """A StreamingRunner whose decoder serves pre-letterboxed canvases and
    their geoms rows from memory (paths name the frame index)."""

    @staticmethod
    def make(pipe, frames, geoms, **kw):
        from litepi_tpu_torch.pipeline import StreamingRunner

        class Runner(StreamingRunner):
            def _decode_batch(self, paths, out=None):
                idx = [int(p.rsplit("/", 1)[1]) for p in paths]
                return frames[idx], geoms[idx]

        return Runner(pipe, use_native_loader=False, **kw)


def stream(cfg, det_vars, cls_vars, frames, geoms, conf, batch_size, with_server=True):
    """Every batch of a ``StreamingRunner`` over ``frames`` (from memory),
    through ``MeshServer`` when ``with_server``."""
    from litepi_tpu_torch.pipeline.serving import MeshServer

    pipe = _pipeline(cfg, det_vars, cls_vars)
    server = MeshServer(pipe, make_mesh(backend="cpu")) if with_server else None
    runner = _MemoryRunner.make(pipe, frames, geoms, batch_size=batch_size, server=server)
    paths = [f"mem://{i}" for i in range(frames.shape[0])]
    return [(p, out) for p, out in runner.run(paths, conf)]


def replication(cases):
    """``put_replicated`` of identical trees, then of ``values[rank]`` for
    each ``values`` in ``cases`` (trees that may differ by rank): each
    case's error message, or None."""
    from litepi_tpu_torch.parallel.mesh import put_replicated

    mesh = make_mesh(backend="cpu")
    same = {"w": torch.arange(6.0).reshape(2, 3), "n": np.asarray(3), "layers": [torch.ones(2)]}
    put_replicated(same, mesh)
    errors = []
    for values in cases:
        try:
            put_replicated(values[mesh.rank], mesh)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    return errors


def mesh_layouts():
    """The meshes a 2-rank group can and cannot make, and the row blocks
    each rank's sharding takes."""
    from litepi_tpu_torch.parallel.mesh import batch_sharding, replicated_sharding

    out = {}
    mesh = make_mesh(backend="cpu")
    out["shape"] = mesh.shape
    out["rows"] = batch_sharding(mesh).rows(6)
    out["replicated_rows"] = replicated_sharding(mesh).rows(6)
    out["model2"] = make_mesh(2, model_parallel=2, backend="cpu").shape
    for key, kw in (("mp3", {"n_devices": 2, "model_parallel": 3}), ("n3", {"n_devices": 3})):
        try:
            make_mesh(backend="cpu", **kw)
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    try:
        batch_sharding(mesh).rows(5)
        out["odd_rows"] = None
    except ValueError as e:
        out["odd_rows"] = str(e)
    # a global batch of 6 rows cut to this rank's, nested leaves included
    from litepi_tpu_torch.data.distributed import distribute_batches
    from litepi_tpu_torch.parallel.mesh import shard_pipeline_batch

    glob = {"frames": np.arange(6 * 4, dtype=np.float32).reshape(6, 4),
            "extra": [np.arange(6), torch.arange(6) * 10]}
    shard = shard_pipeline_batch(mesh, glob)
    out["pipeline_batch"] = {"frames": shard["frames"].numpy(),
                             "extra": [t.numpy() for t in shard["extra"]],
                             "types": sorted({type(t).__name__ for t in
                                              (shard["frames"], *shard["extra"])})}
    try:
        shard_pipeline_batch(mesh, {"frames": np.zeros((5, 4))})
        out["odd_pipeline_batch"] = None
    except ValueError as e:
        out["odd_pipeline_batch"] = str(e)
    # a rank's host batches (its own rows already) lifted as they are
    local = [{"images": np.full((3, 2), 10 * mesh.rank + i, np.float32)} for i in range(2)]
    out["distributed"] = [{k: (type(v).__name__, v.numpy()) for k, v in b.items()}
                          for b in distribute_batches(mesh, iter(local))]
    out["jax_modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "flax", "litepi_tpu"))
    return out


def detector_steps(cfg, variables, batches, total, warmup):
    """float32 detector train steps on this rank's rows of each global
    batch in ``batches``; the parameters, BatchNorm statistics and EMA
    (Flax-named trees) and the metrics after each step."""
    from litepi_tpu_torch.parallel.mesh import batch_sharding, put_replicated
    from litepi_tpu_torch.train import detector as pdet
    from litepi_tpu_torch.weights.jax_bridge import jax_to_state_dict, state_dict_to_jax

    mesh = make_mesh(backend="cpu")
    model, state, tx = pdet.create_detector_train_state(
        cfg, lr=1e-2, dtype=torch.float32, total_steps=total, warmup_steps=warmup,
        device="cpu")
    model.load_state_dict(jax_to_state_dict(variables))
    state.ema_params = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = put_replicated(state, mesh)
    rows = batch_sharding(mesh).shard
    runs = []
    for batch in batches:
        local = pdet.to_device_batch({k: rows(v) for k, v in batch.items()},
                                     torch.device("cpu"))
        state, m = pdet.detector_train_step(model, tx, state, local, cfg=cfg, mesh=mesh)
        put_replicated(state, mesh)  # the ranks stay identical
        sd = model.state_dict()
        runs.append({
            "vars": state_dict_to_jax(sd),
            "ema": state_dict_to_jax({**sd, **state.ema_params})["params"],
            "metrics": {k: float(v) for k, v in m.items()},
        })
    return runs


def frcnn_steps(batch, steps=2, seed=0):
    """Faster R-CNN train steps in float64 (the model's float32 casts
    stay) on this rank's rows of ``batch``, the loss's draws from a
    generator seeded ``seed``: the metrics after each step and the
    parameters' checksum."""
    from litepi_tpu_torch.parallel.mesh import batch_sharding
    from litepi_tpu_torch.train.baselines import (
        baseline_train_step,
        create_baseline_train_state,
    )
    from litepi_tpu_torch.train.detector import to_device_batch

    mesh = make_mesh(backend="cpu")
    size = batch["images"].shape[1]
    state, tx = create_baseline_train_state(
        "faster_rcnn", 1, size, pre_nms_topk=64, post_nms_topk=16, dtype=torch.float64,
        device="cpu")
    state.model.double()
    state.opt_state = tx.init(list(state.model.parameters()))
    gen = torch.Generator().manual_seed(seed)
    rows = batch_sharding(mesh).shard
    local = to_device_batch({k: rows(v) for k, v in batch.items()}, torch.device("cpu"))
    metrics = []
    for _ in range(steps):
        state, m = baseline_train_step(state, tx, local, draws=gen, mesh=mesh)
        metrics.append({k: float(v) for k, v in m.items()})
    checksum = float(sum(float(p.detach().abs().sum()) for p in state.model.parameters()))
    return {"metrics": metrics, "param_sum": checksum}


def hang(seconds):
    """A rank that outlives any test's limit."""
    import time

    time.sleep(seconds)


def detector_cli(argv):
    """``apps/train_detector.py``'s main in a rank of a group started
    outside the CLI (``WORLD_SIZE`` set, as under ``torchrun``)."""
    from litepi_tpu_torch.apps.train_detector import main

    return main(argv)
