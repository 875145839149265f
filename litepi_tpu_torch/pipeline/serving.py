"""Data-parallel serving: the fused two-stage program over a mesh's ranks.

The port's counterpart of the JAX package's ``pipeline/serving.py``.  The
scale-out dimension is the batch over the mesh's data axis
(``parallel/mesh.py``): parameters are replicated (checked identical on
every rank, never synchronised), and each rank runs its contiguous block of
frames through its own pipeline's ``run_fused``.  The program has one
cross-frame step, the classifier's global crop budget, which takes one
all-gather of the ranking scores (``TwoStagePipeline._classify_budgeted``);
:meth:`MeshServer.serve` then all-gathers the outputs, so every rank
returns the (B, ...) global result that JAX's sharded arrays hold.

Usage, in each rank::

    mesh = make_mesh()                      # all ranks of the group
    server = MeshServer(pipe, mesh)
    out = server.serve(frames)              # (B, ...) padded outputs

``serve`` accepts any batch divisible by the data-axis size.  On one rank
it is exactly ``pipe.run_fused``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from litepi_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    batch_sharding,
    put_replicated,
)
from litepi_tpu_torch.pipeline.two_stage import TwoStagePipeline


class MeshServer:
    def __init__(self, pipe: TwoStagePipeline, mesh: Mesh) -> None:
        if pipe.device != mesh.device:
            raise ValueError(f"pipeline on {pipe.device}, this rank's device is {mesh.device}")
        self.pipe = pipe
        self.mesh = mesh
        self._batch_sharding = batch_sharding(mesh)
        # parameters replicated across the mesh: every rank must hold the
        # same weights (deterministic init or the same checkpoint)
        put_replicated([pipe.det_model, pipe.cls_model], mesh)

    @property
    def data_parallelism(self) -> int:
        return self.mesh.shape["data"]

    def _conf(self, conf_threshold: Optional[float]) -> float:
        return self.pipe.cfg.benchmark_conf if conf_threshold is None else conf_threshold

    def serve(
        self,
        frames,
        conf_threshold: Optional[float] = None,
        area_scale=None,
    ) -> Dict[str, torch.Tensor]:
        """Run the fused program with the batch sharded over the data axis.

        frames: the global batch, (B, H, W, 3) uint8 (numpy or tensor) with
        B % data_parallelism == 0; each rank runs its own rows.
        area_scale: optional (B,) per-frame box-area rescale for the
        min-area floor (the native pre-letterboxed feed passes 1/ratio^2,
        see ``TwoStagePipeline.run_fused``), sharded alongside the batch.
        Returns the global (B, ...) outputs on this rank's device.
        """
        rows = self._batch_sharding.rows(frames.shape[0])  # raises if indivisible
        if area_scale is not None:
            if not isinstance(area_scale, torch.Tensor):
                area_scale = np.asarray(area_scale, np.float32)
            area_scale = area_scale[rows]
        return self.gather(self._run(frames[rows], self._conf(conf_threshold), area_scale))

    def serve_local(
        self, local_frames, conf_threshold: Optional[float] = None
    ) -> Dict[str, torch.Tensor]:
        """Serving from a rank-local feed: ``local_frames`` is THIS rank's
        shard (the input contract of :mod:`litepi_tpu_torch.data.
        distributed`); the global batch is ``local * data_parallelism``,
        assembled without any frame crossing between ranks.  Returns this
        rank's rows (:meth:`gather` collects every rank's, as
        ``multihost_utils.process_allgather`` does for JAX).  On one rank
        this is exactly :meth:`serve`."""
        return self._run(local_frames, self._conf(conf_threshold))

    def gather(self, outputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Every data rank's rows of ``outputs``, stacked in rank order."""
        group = self.mesh.data_group
        return {k: all_gather_rows(v, group) for k, v in outputs.items()}

    def _run(self, frames, conf: float, area_scale=None) -> Dict[str, torch.Tensor]:
        return self.pipe.run_fused(frames, conf, area_scale, group=self.mesh.data_group)
