"""The port's Faster R-CNN at an input size that is not a multiple of 64,
against the JAX package's, on the CPU.

At 96 the five levels hold 2,298 anchors (each level's cells rounded down)
and the RPN scores 2,307 positions (P6's stride-2 conv rounds up), so the
top-k indices reach past the anchors.  JAX's ``anchors[idx]`` clamps them
(XLA's gather), and the port's gather clamps them the same way: the
float32 forward within tests/test_torch_faster_rcnn.py's tolerances (1e-4
relative to each output's largest magnitude, ``proposal_valid`` equal).
The RPN loss cannot take the mismatch on either side: JAX's raises a
``TypeError`` (shapes (B, 2,307) and (B, 2,298)), and the port's raises
too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import litepi_tpu.models.faster_rcnn as jfr
import litepi_tpu_torch.models.faster_rcnn as pfr
from litepi_tpu.train.frcnn_loss import frcnn_loss as jax_frcnn_loss
from litepi_tpu_torch.train.frcnn_loss import frcnn_loss
from litepi_tpu_torch.weights.jax_bridge import jax_to_state_dict
from tests.torch_port_helpers import (
    one_torch_thread,  # noqa: F401 (a fixture)
    random_jax_vars,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NC, SIZE, PRE, POST = 2, 96, 4096, 32
REL = 1e-4


@pytest.fixture(scope="module")
def outputs():
    jm = jfr.FasterRCNN(num_classes=NC, input_size=SIZE, pre_nms_topk=PRE, post_nms_topk=POST)
    variables = random_jax_vars(jm, seed=3, spatial=64)
    pm = pfr.FasterRCNN(num_classes=NC, input_size=SIZE, pre_nms_topk=PRE, post_nms_topk=POST)
    pm.load_state_dict(jax_to_state_dict(variables))
    x = np.random.default_rng(0).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    want = jax.tree.map(np.asarray, jax.jit(lambda v, x: jm.apply(v, x))(variables, x))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    return got, want


def test_forward_at_96_matches_jax(outputs):
    got, want = outputs
    got = {k: v.numpy() for k, v in got.items()}
    assert want["rpn_obj"].shape[1] == 2307 and want["anchors"].shape[0] == 2298
    np.testing.assert_array_equal(got["proposal_valid"], want["proposal_valid"])
    assert want["proposal_valid"].sum() > 8
    for k in ("rpn_obj", "rpn_deltas", "anchors", "proposals", "proposal_scores", "roi_cls",
              "roi_reg"):
        assert got[k].shape == want[k].shape, k
        rel = float(np.abs(got[k] - want[k]).max() / max(float(np.abs(want[k]).max()), 1e-30))
        assert rel <= REL, (k, rel)


def test_rpn_loss_at_96_raises_on_both_sides(outputs):
    got, want = outputs
    gt = np.tile(np.array([10, 10, 50, 50], np.float32), (2, 3, 1))
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax_frcnn_loss(want, jnp.asarray(gt), jnp.zeros((2, 3), jnp.int32),
                       jnp.ones((2, 3), bool), jax.random.PRNGKey(0))
    with pytest.raises(RuntimeError, match="size of tensor"):
        frcnn_loss(got, torch.from_numpy(gt), torch.zeros(2, 3, dtype=torch.int32),
                   torch.ones(2, 3, dtype=torch.bool), torch.Generator().manual_seed(0))
