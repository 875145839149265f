"""The port's multi-process dryrun (``litepi_tpu_torch/parallel/
multiprocess.py``, the counterpart of tests/test_multiprocess_mesh.py) on
the CPU: the flow at 1 gloo rank and at 2 over the same global batches
(``shard_paths`` coverage, one float32 train step, ``serve_local`` with a
binding classifier budget, the checkpoint's crash-swap promotion) agrees:
served outputs bit-equal, loss and parameter checksum within 1e-6
relative.  The comparison itself flags a wrong collective's size of
error.  Each spawn has a 120 s limit and kills its ranks on expiry."""

import copy

import numpy as np

from litepi_tpu_torch.parallel.multiprocess import compare_runs, run_multiprocess_dryrun


def test_one_and_two_ranks_agree():
    res = run_multiprocess_dryrun(2, device="cpu", timeout=120.0, threads=1)
    single, multi = res["single"], res["multi"]
    assert single["processes"] == 1 and multi["processes"] == 2
    assert np.isfinite(multi["loss"]) and multi["param_sum"] > 0
    served = multi["served"]
    assert served["boxes"].shape == (8, 8, 4) and served["valid"].any()
    # the budget bound: fewer classified slots than valid detections before it
    assert served["valid"].sum() == 20
    bent = copy.deepcopy(multi)
    bent["loss"] *= 1 + 1e-5
    bent["served"]["cls_scores"] = bent["served"]["cls_scores"] + 1e-7
    assert set(compare_runs(single, bent, exact=True)) == {"loss", "cls_scores"}
    assert compare_runs(single, bent, exact=False) == {"loss": (single["loss"], bent["loss"])}
