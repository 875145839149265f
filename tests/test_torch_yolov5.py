"""The port's YOLOv5n (litepi_tpu_torch/models/yolov5.py) against the JAX
package's: both heads on the same variables, the anchor table, the v5
decode and the top-k candidate decoder.

Float32 on the CPU, B=2 128x128 canvases.  Head outputs are O(1) and
compared at 2e-4 absolute (convolution sum order).  The decoders get the
same raw predictions on both sides: boxes within 1e-4 px, scores 1e-6,
the selected indices and class ids exact, ties included (both take the
lower index first).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litepi_tpu.models.init_utils import fast_init
from litepi_tpu.models.yolov5 import YoloV5 as JaxYoloV5
from litepi_tpu.models.yolov5 import decode_v5 as jax_decode_v5
from litepi_tpu.models.yolov5 import v5_anchor_table as jax_anchor_table
from litepi_tpu.models.yolov5 import v5_candidates as jax_v5_candidates
from litepi_tpu_torch.models import V5CandidateDecoder, YoloV5
from litepi_tpu_torch.models.yolov5 import decode_v5, v5_anchor_table, v5_candidates
from litepi_tpu_torch.ops.dfl import topk_stable
from litepi_tpu_torch.weights import jax_to_state_dict
from tests.torch_port_helpers import perturb_batchnorm

HEAD_ATOL = 2e-4


@pytest.mark.parametrize("anchor_free", [True, False])
def test_yolov5_matches_jax(anchor_free):
    jvars = perturb_batchnorm(fast_init(JaxYoloV5(anchor_free=anchor_free), seed=2), seed=3)
    x = np.random.default_rng(4).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: JaxYoloV5(anchor_free=anchor_free).apply(v, x, train=False))(
        jvars, x)
    model = YoloV5(anchor_free=anchor_free)
    model.load_state_dict(jax_to_state_dict(jvars))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert set(got) == set(want) == ({"reg", "cls"} if anchor_free else {"pred"})
    assert model.stem.conv.padding == (2, 2) and model.stem.conv.kernel_size == (6, 6)
    n_jax = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(jvars["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    if not anchor_free:  # 3 priors x (16^2 + 8^2 + 4^2) cells
        assert got["pred"].shape == (2, 1008, 6) and got["pred"].dtype == torch.float32
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), atol=HEAD_ATOL, rtol=0)


@pytest.mark.parametrize("size", [320, 640])
def test_anchor_table_equals_jax(size):
    for got, want in zip(v5_anchor_table(size), jax_anchor_table(size)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert V5CandidateDecoder(size, device="cpu").capacity == 3 * sum(
        (size // s) ** 2 for s in (8, 16, 32))


def _pred(seed, n_classes, quantised):
    """Raw head output (2, 1575, 5 + nc) at 160: normal logits, or logits on
    a coarse grid whose products tie exactly."""
    rng = np.random.default_rng(seed)
    pred = rng.normal(0, 2, (2, 1575, 5 + n_classes)).astype(np.float32)
    if quantised:
        pred[..., 4:] = rng.integers(-4, 4, pred[..., 4:].shape) * 0.5
    return pred


def _tables(size=160):
    t = jax_anchor_table(size)
    return [jnp.asarray(a) for a in t], [torch.from_numpy(a) for a in t]


@pytest.mark.parametrize("n_classes, quantised", [(1, False), (3, False), (3, True)])
def test_v5_candidates_match_jax(n_classes, quantised):
    pred = _pred(n_classes * 10 + quantised, n_classes, quantised)
    jt, tt = _tables()
    k = 200
    wb, ws, wc = (np.asarray(a) for a in jax_v5_candidates(jnp.asarray(pred), *jt, k))
    gb, gs, gc = (a.numpy() for a in v5_candidates(torch.from_numpy(pred), *tt, k))
    # the selected indices: jax.lax.top_k's order, ties to the lower index
    p = 1 / (1 + np.exp(-pred.astype(np.float64)))
    scores = (p[..., 5:].max(-1) * p[..., 4]).astype(np.float32)
    _, jidx = jax.lax.top_k(jnp.asarray(scores), k)
    _, tidx = topk_stable(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    if quantised:
        assert (ws[:, 1:] == ws[:, :-1]).sum() > 100  # exact ties inside the top k
    np.testing.assert_allclose(gs, ws, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_allclose(gb, wb, atol=1e-4, rtol=0)
    assert gb.shape == (2, k, 4) and gc.dtype == np.int32


def test_decode_v5_matches_jax():
    pred = _pred(5, 3, False)
    jt, tt = _tables()
    want = [np.asarray(a) for a in jax_decode_v5(jnp.asarray(pred), *jt)]
    got = [a.numpy() for a in decode_v5(torch.from_numpy(pred), *tt)]
    np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[2], want[2])


def test_v5_decode_geometry():
    """One planted prediction decodes to its cell centre and prior, by hand:
    prior 0 of cell (5, 5) at P3 -> centre 44, wh (10, 13)."""
    _, tt = _tables(320)
    pred = torch.full((1, 6300, 6), -20.0)
    a = 3 * (40 * 5 + 5)
    pred[0, a, :4] = 0.0
    pred[0, a, 4:] = 10.0
    boxes, scores, _ = v5_candidates(pred, *tt, 1)
    torch.testing.assert_close(boxes[0, 0], torch.tensor([39.0, 37.5, 49.0, 50.5]))
    assert float(scores[0, 0]) > 0.999
