"""The port's data-parallel Faster R-CNN step (``train/baselines.py::
baseline_train_step`` with a mesh) at 2 gloo ranks against 1 rank, on the
CPU.

The step's batch-wide parts are all global at 2 ranks: the ResNet-50's
BatchNorm moments, the RPN's and the ROI head's sample counts, and the
sampling draws, which a generator makes for the whole (B, A) batch and
each rank slices.  A tiny Faster R-CNN's float32 step is mostly rounding
noise (near-tie proposals; ROADMAP §3), so the steps run in float64 (the
model's float32 casts stay), as the port's Faster R-CNN parity does: two
steps, every metric and the parameters' checksum within 1e-6 relative,
the sample counts equal.
"""

import math

import numpy as np
import pytest

from litepi_tpu_torch.parallel.multiprocess import spawn_ranks
from tests.torch_dp_workers import frcnn_steps
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LIMIT = 120.0


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    b, g, size = 2, 4, 64
    xy = rng.uniform(0, size - 30, (b, g, 2))
    batch = {
        "images": rng.uniform(0, 1, (b, size, size, 3)),
        "gt_boxes": np.concatenate([xy, xy + rng.uniform(12, 30, (b, g, 2))], -1),
        "gt_labels": np.zeros((b, g), np.int32),
        "gt_mask": np.ones((b, g), bool),
    }
    return {1: [frcnn_steps(batch)],  # one rank: this process, outside any group
            2: spawn_ranks("tests.torch_dp_workers:frcnn_steps", 2, {"batch": batch},
                           device="cpu", timeout=LIMIT, threads=1)}


def test_two_rank_faster_rcnn_steps_equal_one_rank(runs):
    (one,) = runs[1]
    for rank in runs[2]:
        for got, want in zip(rank["metrics"], one["metrics"]):
            assert set(got) == set(want)
            assert got["rpn_pos"] == want["rpn_pos"] > 0
            assert got["roi_pos"] == want["roi_pos"]
            for k in want:
                assert math.isclose(got[k], want[k], rel_tol=1e-6, abs_tol=1e-12), k
        assert math.isclose(rank["param_sum"], one["param_sum"], rel_tol=1e-6)


def test_the_draws_are_the_global_batchs():
    """Under a 2-rank group each rank's draws are its rows of the draws a
    generator makes for the whole batch (``frcnn_draws``, in one process
    with the group faked)."""
    import torch
    import torch.distributed as dist

    from litepi_tpu_torch.parallel.mesh import Mesh, global_batch
    from litepi_tpu_torch.train.frcnn_loss import frcnn_draws

    out = {"rpn_obj": torch.zeros(3, 10), "proposal_valid": torch.zeros(3, 4)}
    whole = frcnn_draws({"rpn_obj": torch.zeros(6, 10), "proposal_valid": torch.zeros(6, 4)},
                        torch.Generator().manual_seed(5))
    for rank in (0, 1):
        fake = pytest.MonkeyPatch()
        fake.setattr(dist, "get_world_size", lambda group=None: 2)
        fake.setattr(dist, "get_rank", lambda group=None: rank)
        try:
            with global_batch(Mesh(2, 1, rank, torch.device("cpu"), data_group="group")):
                mine = frcnn_draws(out, torch.Generator().manual_seed(5))
        finally:
            fake.undo()
        for m, w in zip(mine, whole):
            torch.testing.assert_close(m, w[3 * rank:3 * rank + 3], rtol=0, atol=0)
