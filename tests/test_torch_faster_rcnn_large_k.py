"""The port's Faster R-CNN with its RPN above 1,024 candidates against the
JAX package's on the CPU: at input 128 the five levels hold 4,092 anchors,
so ``pre_nms_topk`` 2,000 (torchvision's training default) sends K = 2,000
candidates per image to the RPN's NMS (``suppress``: the NMS kernel on the
card, ``suppress_sorted`` here, which JAX runs too).  The float32 forward
within tests/test_torch_faster_rcnn.py's tolerances (1e-4 relative to each
output's largest magnitude, ``proposal_valid`` equal), and the RPN's keep
mask equal to JAX's ``suppress_sorted`` on JAX's own candidates."""

import jax
import numpy as np
import pytest
import torch

import litepi_tpu.models.faster_rcnn as jfr
import litepi_tpu_torch.models.faster_rcnn as pfr
from litepi_tpu.ops.nms import suppress_sorted as jax_suppress_sorted
from litepi_tpu_torch.ops.nms import suppress_sorted
from litepi_tpu_torch.weights.jax_bridge import jax_to_state_dict
from tests.torch_port_helpers import (
    one_torch_thread,  # noqa: F401 (a fixture)
    random_jax_vars,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NC, SIZE, PRE, POST = 2, 128, 2000, 32
REL = 1e-4


@pytest.fixture(scope="module")
def models():
    jm = jfr.FasterRCNN(num_classes=NC, input_size=SIZE, pre_nms_topk=PRE, post_nms_topk=POST)
    variables = random_jax_vars(jm, seed=3, spatial=64)
    pm = pfr.FasterRCNN(num_classes=NC, input_size=SIZE, pre_nms_topk=PRE, post_nms_topk=POST)
    pm.load_state_dict(jax_to_state_dict(variables))
    return jm, variables, pm.eval()


def _images(b=2, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (b, SIZE, SIZE, 3)).astype(np.float32)


def test_forward_at_pre_nms_topk_2000_matches_jax(models, monkeypatch):
    jm, variables, pm = models
    x = _images()
    want = jax.tree.map(np.asarray, jax.jit(lambda v, x: jm.apply(v, x))(variables, x))
    assert want["rpn_obj"].shape[1] == 4092
    ks = []
    real = pfr.suppress
    monkeypatch.setattr(pfr, "suppress", lambda b, *a: (ks.append(b.shape[1]), real(b, *a))[1])
    with torch.no_grad():
        got = {k: v.numpy() for k, v in pm(torch.from_numpy(x).permute(0, 3, 1, 2)).items()}
    assert ks == [PRE]
    np.testing.assert_array_equal(got["proposal_valid"], want["proposal_valid"])
    assert want["proposal_valid"].sum() > 8
    for k in ("rpn_obj", "rpn_deltas", "anchors", "proposals", "proposal_scores", "roi_cls",
              "roi_reg"):
        rel = float(np.abs(got[k] - want[k]).max() / max(float(np.abs(want[k]).max()), 1e-30))
        assert rel <= REL, (k, rel)


def test_rpn_keep_mask_at_k2000_matches_jax():
    """The RPN's suppression alone at K = 2,000 (IoU 0.7, one class), on
    crowded candidates: the port's keep mask equals JAX's bit for bit, and
    it both keeps and suppresses."""
    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 90, (2, PRE, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 30, (2, PRE, 2))], -1).astype(np.float32)
    valid = rng.uniform(size=(2, PRE)) < 0.9
    cls = np.zeros((2, PRE), np.int32)
    want = np.stack([np.asarray(jax_suppress_sorted(boxes[i], valid[i], cls[i], 0.7))
                     for i in range(2)])
    got = suppress_sorted(torch.from_numpy(boxes), torch.from_numpy(valid),
                          torch.from_numpy(cls), 0.7).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()
