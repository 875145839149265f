"""The port's mesh and distributed input (``litepi_tpu_torch/parallel/
mesh.py``, ``data/distributed.py``, ``parallel/multiprocess.py::
spawn_ranks``) on the CPU, over gloo ranks that the tests start.

``shard_paths`` equals the JAX package's over several (n, index, count)
and raises as it does out of range; a 2-rank group makes the ('data',
'model') meshes that divide it and refuses the others with JAX's message;
the data axis takes contiguous row blocks in rank order, through
``shard_pipeline_batch`` and ``distribute_batches`` too; ``put_replicated``
raises on a rank whose values differ and passes identical ones; a failing
rank takes the spawn down with its log, and a hung one is stopped at the
spawn's limit.  Every spawn has its own limit (120 s) and kills its ranks
on expiry.
"""

import time

import numpy as np
import pytest
import torch

from litepi_tpu.data.distributed import shard_paths as jax_shard_paths
from litepi_tpu_torch.data.distributed import make_global_batch, shard_paths
from litepi_tpu_torch.parallel.mesh import make_mesh
from litepi_tpu_torch.parallel.multiprocess import spawn_ranks

LIMIT = 120.0


def ranks(target, n=2, **kwargs):
    return spawn_ranks(f"tests.torch_dp_workers:{target}", n, kwargs, device="cpu",
                       timeout=LIMIT, threads=1)


@pytest.mark.parametrize("n,index,count", [(19, 0, 2), (19, 1, 2), (23, 3, 4), (5, 4, 8),
                                           (0, 0, 3), (10, 0, 1)])
def test_shard_paths_equals_jax(n, index, count):
    paths = [f"im{i:03d}.jpg" for i in range(n)]
    assert shard_paths(paths, index, count) == jax_shard_paths(paths, index, count)


def test_shard_paths_range_error_and_default():
    paths = list(range(10))
    for index, count in ((4, 4), (-1, 2)):
        with pytest.raises(ValueError, match="out of range"):
            shard_paths(paths, index, count)
        with pytest.raises(ValueError, match="out of range"):
            jax_shard_paths(paths, index, count)
    assert shard_paths(paths) == paths  # one process: identity


def test_one_process_mesh_and_global_batch():
    mesh = make_mesh(backend="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.data_group is None
    local = {"images": np.zeros((3, 4, 4, 3), np.float32), "mask": np.ones((3, 2), bool)}
    glob = make_global_batch(mesh, local)
    assert glob["images"].shape == (3, 4, 4, 3) and glob["mask"].dtype == torch.bool
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(2, backend="cpu")
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        make_mesh(1, model_parallel=2, backend="cpu")


def test_mesh_on_the_card_needs_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        spawn_ranks("tests.torch_dp_workers:mesh_layouts", 2)


@pytest.fixture(scope="module")
def layouts():
    return ranks("mesh_layouts")


def test_two_rank_mesh_shapes(layouts):
    for r, out in enumerate(layouts):
        assert out["shape"] == {"data": 2, "model": 1}
        assert out["model2"] == {"data": 1, "model": 2}
        assert out["rows"] == slice(3 * r, 3 * r + 3)
        assert out["replicated_rows"] == slice(0, 6)


def test_two_rank_batches_take_contiguous_rows(layouts):
    """``shard_pipeline_batch`` gives rank r rows 3r..3r+2 of a global batch
    of 6 in every leaf (nested ones too) as tensors, and refuses 5 rows;
    ``distribute_batches`` lifts each of a rank's host batches, its own
    rows already, to tensors unchanged and in order."""
    glob = np.arange(6 * 4, dtype=np.float32).reshape(6, 4)
    for r, out in enumerate(layouts):
        got = out["pipeline_batch"]
        np.testing.assert_array_equal(got["frames"], glob[3 * r : 3 * r + 3])
        np.testing.assert_array_equal(got["extra"][0], np.arange(3 * r, 3 * r + 3))
        np.testing.assert_array_equal(got["extra"][1], np.arange(3 * r, 3 * r + 3) * 10)
        assert got["types"] == ["Tensor"]
        assert "batch 5 not divisible by data axis 2" in out["odd_pipeline_batch"]
        assert len(out["distributed"]) == 2
        for i, batch in enumerate(out["distributed"]):
            kind, images = batch["images"]
            assert kind == "Tensor"
            np.testing.assert_array_equal(images, np.full((3, 2), 10 * r + i, np.float32))


def test_ranks_load_no_jax(layouts):
    """The ranks run ``python -m litepi_tpu_torch.parallel.multiprocess``:
    neither JAX nor the JAX package is loaded in them."""
    assert [out["jax_modules"] for out in layouts] == [[], []]


def test_two_rank_mesh_refusals(layouts):
    for out in layouts:
        assert "2 devices not divisible by model_parallel=3" in out["mp3"]
        assert "needs 3 ranks" in out["n3"]
        assert "batch 5 not divisible by data axis 2" in out["odd_rows"]


def test_put_replicated_raises_on_differing_values():
    same = [{"a": torch.ones(3), "b": [np.arange(4)]}] * 2
    differ = [{"a": torch.ones(3), "b": [np.arange(4)]},
              {"a": torch.ones(3), "b": [np.arange(4) * 2]}]
    shorter = [{"a": torch.ones(3)}, {"a": torch.ones(2)}]
    for errors in ranks("replication", cases=[same, differ, shorter]):
        assert errors[0] is None
        assert "different values" in errors[1] and "different sizes" in errors[2], errors


def test_failing_rank_stops_the_spawn():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank \d failed"):
        ranks("replication", cases=[None])  # None[rank] raises in every rank
    assert time.monotonic() - t0 < LIMIT


def test_hung_rank_is_stopped_at_the_limit():
    with pytest.raises(TimeoutError, match="still running"):
        spawn_ranks("tests.torch_dp_workers:hang", 2, {"seconds": 600}, device="cpu",
                    timeout=3.0)
