"""The ('data', 'model') mesh over ``torch.distributed``: one rank per device.

The port's counterpart of the JAX package's ``parallel/mesh.py``.  There one
process drives n devices, and ``jit`` over a batch-sharded global array
gives the global-batch program, with every collective inserted by XLA.
Here each device is driven by its own process, a rank of a
``torch.distributed`` group (NCCL on the card, gloo on the CPU), and the
contract is the same: N ranks compute what one device computes on the same
global batch.

* ``data`` axis: the batch is split into contiguous row blocks, rank order,
  as ``PartitionSpec("data")`` lays rows out; parameters are replicated.
  The few batch-wide reductions of the programs (BatchNorm's moments in
  training, the losses' normalisers, the classifier's crop budget, the
  gradients) are collectives over the data ranks (:func:`global_batch`,
  :func:`all_reduce_sum`, :func:`all_gather_rows`).
* ``model`` axis: kept in the mesh (size 1 by default), as in JAX; ranks
  that differ only in their model index hold the same rows.

A rank lays out in the mesh as JAX's device grid does:
``rank // model_parallel`` on the data axis, ``rank % model_parallel`` on
the model axis.  Ranks are started by ``parallel/multiprocess.py::
spawn_ranks`` (the training CLIs' ``--data_parallel``), or by ``torchrun``
(:func:`make_mesh` then joins the group its environment describes).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from litepi_tpu_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a ('data', 'model') mesh: the axis sizes, its
    rank and device, and the process group of the ranks that share its
    model index (its data axis; None on a one-rank axis)."""

    data: int
    model: int
    rank: int
    device: torch.device
    data_group: Optional[Any] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model


def _platform_backend(platform: str) -> str:
    return "nccl" if platform == "cuda" else "gloo"


def rank_device(platform: str, rank: int) -> torch.device:
    """The device of ``rank`` on ``platform`` (``"cuda"`` or ``"cpu"``):
    ``cuda:LOCAL_RANK`` (the rank itself without a launcher's
    ``LOCAL_RANK``), shared round-robin only under gloo, which stages its
    collectives through the host; NCCL needs a card per rank."""
    dev = resolve_device(platform)
    if dev.type == "cpu":
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank))
    cards = torch.cuda.device_count()
    if dist.is_initialized() and dist.get_backend() == "nccl" and dist.get_world_size() > cards:
        raise ValueError(
            f"NCCL needs one card per rank: {dist.get_world_size()} ranks, {cards} "
            "visible card(s)"
        )
    return torch.device("cuda", local % cards)


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    backend: Optional[str] = None,
) -> Mesh:
    """This rank's ('data', 'model') mesh of ``n_devices`` ranks (default:
    every rank of the group; 1 in a process outside any group).

    ``backend`` names the platform as the JAX package's ``make_mesh`` does:
    ``"cuda"`` (the default: the card) or ``"cpu"``.  A process outside any
    group joins the one its environment describes when ``WORLD_SIZE`` > 1
    (``torchrun``; NCCL on the card, gloo on the CPU); otherwise only a
    one-rank mesh can be made.  Raises ``ValueError`` when ``n_devices``
    is not the group's size or is not divisible by ``model_parallel``.
    """
    platform = backend or "cuda"
    if platform not in ("cuda", "cpu"):
        raise ValueError(f"unknown platform {platform!r}: 'cuda' or 'cpu'")
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        bound = {}
        if platform == "cuda":
            bound["device_id"] = rank_device(platform, int(os.environ.get("RANK", "0")))
            torch.cuda.set_device(bound["device_id"])
        dist.init_process_group(_platform_backend(platform), **bound)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(
            f"a mesh of {n} devices needs {n} ranks, one per device; this process is "
            f"one of {world} (start them with litepi_tpu_torch.parallel.multiprocess."
            "spawn_ranks or torchrun)"
        )
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    device = rank_device(platform, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    data = n // model_parallel
    group = None
    if data > 1:
        if model_parallel == 1:
            group = dist.group.WORLD
        else:
            # every rank creates every data group, in the same order
            for m in range(model_parallel):
                g = dist.new_group([d * model_parallel + m for d in range(data)])
                if rank % model_parallel == m:
                    group = g
    return Mesh(data, model_parallel, rank, device, group)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A layout over ``mesh``: ``axis="data"`` splits the leading dim into
    the data ranks' contiguous row blocks, ``axis=None`` replicates."""

    mesh: Mesh
    axis: Optional[str] = None

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch`` rows."""
        if self.axis is None:
            return slice(0, batch)
        n = self.mesh.data
        if batch % n:
            raise ValueError(f"batch {batch} not divisible by data axis {n}")
        per = batch // n
        return slice(self.mesh.data_index * per, (self.mesh.data_index + 1) * per)

    def shard(self, x):
        """This rank's part of ``x`` (its rows, or all of it)."""
        return x[self.rows(x.shape[0])]


def batch_sharding(mesh: Mesh) -> Sharding:
    """Shard the leading (batch) dimension over the data axis."""
    return Sharding(mesh, "data")


def replicated_sharding(mesh: Mesh) -> Sharding:
    """Full replication (parameters)."""
    return Sharding(mesh, None)


def tree_map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(v, fn) for v in tree)
    return fn(tree)


def to_device(x, device: torch.device):
    """``x`` (a tensor, a numpy array or a module) on ``device``; other
    values as they are."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device) if isinstance(x, (torch.Tensor, nn.Module)) else x


def shard_pipeline_batch(mesh: Mesh, batch: Any) -> Any:
    """A tree of batch-leading arrays (numpy or tensors) as this rank's
    rows on its device.  Raises ``ValueError`` when a batch does not divide
    by the data axis."""
    sharding = batch_sharding(mesh)
    return tree_map(batch, lambda x: to_device(sharding.shard(x), mesh.device))


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, nn.Module):
        return list(tree.state_dict().values())
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return _leaves([getattr(tree, f.name) for f in dataclasses.fields(tree)])
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    if isinstance(tree, np.ndarray):
        return [torch.from_numpy(np.ascontiguousarray(tree))]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (bool, int, float)):
        return [torch.tensor(float(tree), dtype=torch.float64)]
    return []


def _uses_host(t: torch.Tensor, group) -> bool:
    """gloo moves a card's tensors through the host: do it here, in the
    open, so every gloo collective sees CPU tensors."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``op`` of ``t`` over ``group``'s ranks (the same bits
    on every rank)."""
    if _uses_host(t, group):
        out = t.detach().cpu().clone()
        dist.all_reduce(out, op=op, group=group)
        return out.to(t.device)
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, op=op, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose gradient is the sum over the ranks of the
    gradients: what the global-batch program differentiates through where
    it sums over the whole batch."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``'s ranks, differentiable (forward and
    backward are each one all-reduce); ``t`` itself without a group."""
    return t if group is None else _AllReduceSum.apply(t, group)


def all_reduce_flat(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Each of ``tensors`` (one dtype) summed over ``group``'s ranks, in one
    all-reduce of their concatenation; the tensors themselves without a
    group."""
    if group is None or not tensors:
        return list(tensors)
    flat = _all_reduce(torch.cat([t.detach().reshape(-1) for t in tensors]), group)
    return [p.view_as(t) for p, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` stacked along dim 0 in rank order (each rank's
    ``t`` of one shape); ``t`` itself without a group."""
    if group is None:
        return t
    host = _uses_host(t, group)
    x = (t.cpu() if host else t).contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts)
    return out.to(t.device) if host else out


def put_replicated(tree: Any, mesh: Mesh) -> Any:
    """``tree`` (tensors, numpy arrays, modules, dataclasses, dicts and
    lists of them) on this rank's device, after checking that every rank of
    the mesh holds identical values: as in the JAX package, replication
    asserts it, it doesn't sync it (deterministic init or a prior load
    makes them equal).  Raises ``ValueError`` when the ranks differ."""
    tree = tree_map(tree, lambda x: to_device(x, mesh.device))
    if mesh.size > 1:
        _check_identical(tree, dist.group.WORLD, mesh.device)
    return tree


def _check_identical(tree: Any, group, device: torch.device) -> None:
    words = [t.detach().to(device).reshape(-1).contiguous().view(torch.uint8)
             for t in _leaves(tree)]
    buf = torch.cat(words) if words else torch.zeros(0, dtype=torch.uint8, device=device)
    buf = torch.cat([buf, buf.new_zeros(-buf.numel() % 8)]).view(torch.int64)
    length = torch.tensor([buf.numel()], dtype=torch.int64, device=device)
    lo, hi = (_all_reduce(length, group, op) for op in (dist.ReduceOp.MIN, dist.ReduceOp.MAX))
    if int(lo) != int(hi):
        raise ValueError("put_replicated: the ranks hold trees of different sizes")
    lo, hi = (_all_reduce(buf, group, op) for op in (dist.ReduceOp.MIN, dist.ReduceOp.MAX))
    if not torch.equal(lo, hi):
        raise ValueError(
            "put_replicated: the ranks hold different values (replication asserts "
            "identical values, it does not sync them)"
        )


def require_agreement(mesh: Optional[Mesh], value: int, what: str) -> None:
    """Raise unless every rank of ``mesh`` holds the same ``value`` (a loop
    whose length differs across ranks would desynchronise their
    collectives)."""
    if mesh is None or mesh.size == 1:
        return
    seen = all_gather_rows(torch.tensor([value], device=mesh.device), dist.group.WORLD)
    seen = sorted(int(v) for v in seen.cpu())
    if seen[0] != seen[-1]:
        raise RuntimeError(
            f"{what}: the ranks disagree ({seen}); a checkpoint directory must live on "
            "a filesystem shared by every rank"
        )


def from_rank0(mesh: Optional[Mesh], value: float) -> float:
    """Rank 0's ``value`` on every rank of ``mesh`` (one broadcast)."""
    if mesh is None or mesh.size == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=mesh.device)
    if _uses_host(t, dist.group.WORLD):
        t = t.cpu()
    dist.broadcast(t, 0)
    return float(t.item())


# the data group of the global batch in scope (global_batch), per context
_BATCH_GROUP: contextvars.ContextVar = contextvars.ContextVar("batch_group", default=None)


@contextlib.contextmanager
def global_batch(mesh: Optional[Mesh]) -> Iterator[None]:
    """Inside this scope the batch-wide statistics of a train step
    (BatchNorm's moments, the losses' normalisers) are taken over the
    global batch of ``mesh``'s data ranks, as under the JAX package's
    data-sharded ``jit``; a one-rank data axis (or no mesh) changes
    nothing."""
    token = _BATCH_GROUP.set(mesh.data_group if mesh is not None else None)
    try:
        yield
    finally:
        _BATCH_GROUP.reset(token)


def batch_group():
    """The process group of the global batch in scope (:func:`global_batch`),
    or None on one rank."""
    return _BATCH_GROUP.get()
