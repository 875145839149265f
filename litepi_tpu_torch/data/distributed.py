"""The distributed input pipeline: each rank reads only its own rows.

The port's counterpart of the JAX package's ``data/distributed.py``.  There
each host process decodes only the shard of the dataset that its own chips
consume, and ``jax.make_array_from_process_local_data`` stitches the
process-local host batches into one global array sharded over the mesh's
'data' axis.  Here each device has its own process, a rank of the mesh
(``parallel/mesh.py``), so a rank's host batch already is its shard of the
global batch: :func:`make_global_batch` places it on the rank's device and
the train step's collectives (``parallel/mesh.py::global_batch``) make the
program a global-batch one.  Every rank must feed equally shaped local
batches, as in JAX.

Under ``torchrun`` (``WORLD_SIZE`` set), that is the JAX multi-process
contract: ``--batch`` is per process and :func:`shard_paths` gives each
rank a disjoint part of the dataset.  One process (a one-rank group, or
none) is the degenerate case of the same code.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch.distributed as dist

from litepi_tpu_torch.parallel.mesh import Mesh, to_device, tree_map


def _rank_and_count():
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_paths(
    paths: Sequence,
    index: Optional[int] = None,
    count: Optional[int] = None,
) -> List:
    """Deterministic per-rank dataset shard: strided ``paths[index::count]``.

    Strided (not contiguous) so sorted-by-name datasets spread any ordering
    bias (e.g. per-class file prefixes) evenly across ranks.  Defaults to
    this process's rank and the group's size (0 and 1 outside a group).
    """
    rank, world = _rank_and_count()
    index = rank if index is None else index
    count = world if count is None else count
    if not 0 <= index < count:
        raise ValueError(f"process index {index} out of range for {count}")
    return list(paths)[index::count]


def make_global_batch(mesh: Mesh, local_batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """This rank's host arrays (leading dim: the per-rank batch) as its
    shard of the global batch of ``local * mesh.shape["data"]`` rows, on
    its device, layout unchanged."""
    return tree_map(local_batch, lambda x: to_device(x, mesh.device))


def distribute_batches(
    mesh: Mesh, batches: Iterator[Dict[str, np.ndarray]]
) -> Iterator[Dict[str, Any]]:
    """Lift a host batch iterator (e.g. ``DetectionDataset.batches``) into
    this rank's shards of the global batches."""
    for batch in batches:
        yield make_global_batch(mesh, batch)
