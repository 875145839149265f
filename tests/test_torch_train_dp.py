"""The port's data-parallel detector step (``train/detector.py::
detector_train_step`` with a mesh) at 2 gloo ranks on the CPU.

The global batch of tests/test_torch_train_detector.py (an
``ablation_configs`` detector, w 0.25, d 0.33, 3 classes, at 128x128,
batch 2, the one-cycle schedule, float32), one row per rank, two steps.
Against the JAX package's ``detector_train_step`` on the whole batch (the
global-batch program): the loss within 1e-5 relative, ``num_fg`` equal,
parameters, BatchNorm statistics and the EMA within 1e-5 absolute plus
1e-5 relative, the single-device parity's bounds.  Against the port's own
step at 1 rank: the loss and the parameters' checksum within 1e-6
relative (JAX's multi-process bound: the ranks' gradient all-reduce sums
in another order), ``num_fg`` equal.  Each rank's state stays identical to
the other's (``put_replicated`` checks it after each step).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from litepi_tpu.train import detector as jdet
from litepi_tpu_torch.parallel.multiprocess import spawn_ranks
from tests.test_torch_train_detector import CFG, PCFG, TOTAL, WARMUP, flat, jax_state, train_batch
from tests.torch_dp_workers import detector_steps
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LIMIT = 120.0
STEPS = 2


@pytest.fixture(scope="module")
def runs():
    jmodel, jstate, jtx, v = jax_state(jnp.float32)
    jstep = jax.jit(lambda s, b: jdet.detector_train_step(jmodel, jtx, s, b, cfg=CFG))
    batches = [train_batch(seed=i) for i in range(STEPS)]
    want = []
    for batch in batches:
        jstate, jm = jstep(jstate, batch)
        want.append((jax.device_get(jstate), jax.device_get(jm)))
    kw = {"cfg": PCFG, "variables": v, "batches": batches, "total": TOTAL, "warmup": WARMUP}
    port = {1: [detector_steps(**kw)],  # one rank: this process, outside any group
            2: spawn_ranks("tests.torch_dp_workers:detector_steps", 2, kw, device="cpu",
                           timeout=LIMIT, threads=1)}
    return want, port


def _checksum(tree):
    return float(sum(np.abs(a).sum() for a in flat(tree).values()))


def _elementwise(got, want, tol=1e-5):
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("step", range(STEPS))
def test_two_ranks_equal_jax_global_batch_step(runs, step):
    want, port = runs
    jstate, jm = want[step]
    for rank in port[2]:
        got = rank[step]
        m = got["metrics"]
        assert abs(m["loss"] - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        assert m["num_fg"] == int(jm["num_fg"]) > 0
        _elementwise(got["vars"]["params"], jstate.params)
        _elementwise(got["vars"]["batch_stats"], jstate.batch_stats)
        _elementwise(got["ema"], jstate.ema_params)


@pytest.mark.parametrize("step", range(STEPS))
def test_two_ranks_equal_one_rank(runs, step):
    _, port = runs
    one = port[1][0][step]
    for rank in port[2]:
        got = rank[step]
        assert math.isclose(got["metrics"]["loss"], one["metrics"]["loss"], rel_tol=1e-6)
        assert got["metrics"]["num_fg"] == one["metrics"]["num_fg"]
        assert math.isclose(_checksum(got["vars"]["params"]), _checksum(one["vars"]["params"]),
                            rel_tol=1e-6)


def test_detector_cli_as_torchrun_ranks(tmp_path):
    """The detector CLI in each of 2 ranks started outside it (as under
    ``torchrun``): the JAX multi-process contract, ``--batch`` per process
    and a strided shard of the images each, steps from the global count
    (4 images / (1 x 2 ranks) = 2); only rank 0 writes."""
    import cv2

    img_dir, lbl_dir = tmp_path / "images", tmp_path / "labels"
    img_dir.mkdir()
    lbl_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        img = rng.integers(0, 120, (96, 128, 3), dtype=np.uint8)
        img[30:60, 40:80] = 240
        cv2.imwrite(str(img_dir / f"im{i}.jpg"), img)
        (lbl_dir / f"im{i}.txt").write_text("0 0.47 0.47 0.31 0.31\n")
    out = tmp_path / "out"
    argv = ["--images", str(img_dir), "--labels", str(lbl_dir), "--imgsz", "64", "--batch", "1",
            "--epochs", "1", "--max_gt", "8", "--output", str(out), "--device", "cpu",
            "--data_parallel", "2"]
    assert spawn_ranks("tests.torch_dp_workers:detector_cli", 2, {"argv": argv}, device="cpu",
                       timeout=LIMIT, threads=1) == [0, 0]
    import torch

    ck = torch.load(out / "resume" / "variables.pt", weights_only=True)
    assert ck["step"] == 2 and np.isfinite(ck["meta"]["best_score"])
    assert sorted(p.name for p in out.iterdir()) == ["best", "last", "results.json", "resume"]
