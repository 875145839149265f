"""The port's detection loss (``litepi_tpu_torch/train/losses.py``)
against the JAX package's, in float32 on the same seeded inputs.

Tolerances: the assigner's discrete outputs (``fg``, target labels, target
boxes) equal; float values within 1e-6 (absolute, relative to the value's
scale where it exceeds 1); gradients with respect to the logits
(``torch.autograd`` against ``jax.grad``) within 1e-5 relative to each
gradient's largest element."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import litepi_tpu.train.losses as jl
import litepi_tpu_torch.train.losses as pl
from litepi_tpu.ops.anchors import make_anchors
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

S, NC = 128, 3


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _inputs(seed, B=2, G=5):
    """Seeded head logits, padded ground truth (a masked-off slot, one
    image's boxes partly outside the grid) and the anchor grid at 128."""
    rng = np.random.default_rng(seed)
    pts, st = make_anchors(S, (8, 16, 32))
    A = pts.shape[0]
    reg = rng.normal(0, 1.5, (B, A, 64)).astype(np.float32)
    cls = rng.normal(-1, 1.5, (B, A, NC)).astype(np.float32)
    xy = rng.uniform(-10, 100, (B, G, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 50, (B, G, 2))], -1).astype(np.float32)
    labels = rng.integers(0, NC, (B, G)).astype(np.int32)
    mask = np.ones((B, G), bool)
    mask[0, -1] = mask[1, -2:] = False
    return reg, cls, boxes, labels, mask, pts, st


def test_pairwise_iou_ciou_equals_jax():
    rng = np.random.default_rng(0)
    g = rng.uniform(0, 60, (2, 4, 4)).astype(np.float32)
    g[..., 2:] += g[..., :2] + 1
    p = rng.uniform(0, 60, (2, 9, 4)).astype(np.float32)
    p[..., 2:] += p[..., :2] * rng.uniform(0.2, 1.5, (2, 9, 2)).astype(np.float32)
    p[0, 0] = g[0, 0]  # a perfect match
    p[1, 1, 2:] = p[1, 1, :2]  # a degenerate box
    want = jax.jit(jl.pairwise_iou_ciou)(g, p)
    got = pl.pairwise_iou_ciou(torch.from_numpy(g), torch.from_numpy(p))
    for a, b in zip(got, want):
        _close(a.numpy(), b)


@pytest.mark.parametrize("seed", [0, 1])
def test_task_aligned_assign_equals_jax(seed):
    reg, cls, boxes, labels, mask, pts, st = _inputs(seed)
    probs = jax.nn.sigmoid(cls)
    dist = np.asarray(jl.dfl_decode(reg, 16))
    pred = np.concatenate([(pts - dist[..., :2]) * st, (pts + dist[..., 2:]) * st], -1)
    want = jax.jit(jl.task_aligned_assign)(probs, pred, pts * st, boxes, labels, mask)
    got = pl.task_aligned_assign(torch.sigmoid(torch.from_numpy(cls)), torch.from_numpy(pred),
                                 torch.from_numpy(pts * st), torch.from_numpy(boxes),
                                 torch.from_numpy(labels), torch.from_numpy(mask))
    assert int(np.asarray(want["fg"]).sum()) > 10
    np.testing.assert_array_equal(got["fg"].numpy(), np.asarray(want["fg"]))
    np.testing.assert_array_equal(got["target_labels"].numpy(), np.asarray(want["target_labels"]))
    np.testing.assert_array_equal(got["target_boxes"].numpy(), np.asarray(want["target_boxes"]))
    for k in ("target_scores", "target_iou"):
        _close(got[k].numpy(), want[k])


def test_assigner_tie_rules():
    """Every anchor whose metric equals the k-th largest is kept (``>=``),
    and an anchor claimed by two gts of equal IoU goes to the first."""
    pts, st = make_anchors(64, (8, 16, 32))
    centers = pts * st
    A = pts.shape[0]
    probs = np.full((1, A, 2), 0.5, np.float32)
    # one predicted box for every anchor: all tie in IoU with each gt
    pred = np.tile(np.array([[[8, 8, 40, 40]]], np.float32), (1, A, 1))
    boxes = np.array([[[8, 8, 40, 40], [8, 8, 40, 40]]], np.float32)
    labels = np.array([[1, 0]], np.int32)  # the first of the two gts wins
    mask = np.ones((1, 2), bool)
    want = jax.jit(jl.task_aligned_assign, static_argnames="topk")(
        probs, pred, centers, boxes, labels, mask, topk=3)
    got = pl.task_aligned_assign(*(torch.from_numpy(a) for a in
                                   (probs, pred, centers, boxes, labels, mask)), topk=3)
    fg = np.asarray(want["fg"])
    assert fg.sum() > 3  # the tie keeps more than k
    np.testing.assert_array_equal(got["fg"].numpy(), fg)
    labels_want = np.asarray(want["target_labels"])
    assert (labels_want[fg] == 1).all()
    np.testing.assert_array_equal(got["target_labels"].numpy(), labels_want)


def test_dfl_loss_equals_jax():
    rng = np.random.default_rng(3)
    reg = rng.normal(0, 2, (2, 50, 64)).astype(np.float32)
    t = rng.uniform(-1, 17, (2, 50, 4)).astype(np.float32)
    _close(pl.dfl_loss(torch.from_numpy(reg), torch.from_numpy(t), 16).numpy(),
           jax.jit(jl.dfl_loss, static_argnums=2)(reg, t, 16))


@pytest.mark.parametrize("seed", [0, 1])
def test_detection_loss_and_grads_equal_jax(seed):
    reg, cls, boxes, labels, mask, pts, st = _inputs(seed)

    def jf(r, c):
        return jl.detection_loss({"reg": r, "cls": c}, jnp.asarray(pts), jnp.asarray(st),
                                 boxes, labels, mask)

    (jloss, jaux), (gr, gc) = jax.jit(
        jax.value_and_grad(jf, argnums=(0, 1), has_aux=True))(reg, cls)
    r = torch.from_numpy(reg).requires_grad_()
    c = torch.from_numpy(cls).requires_grad_()
    loss, aux = pl.detection_loss({"reg": r, "cls": c}, torch.from_numpy(pts),
                                  torch.from_numpy(st), torch.from_numpy(boxes),
                                  torch.from_numpy(labels), torch.from_numpy(mask))
    loss.backward()
    _close(loss.detach().numpy(), jloss)
    assert int(aux["num_fg"]) == int(jaux["num_fg"]) > 10
    for k in ("loss_box", "loss_cls", "loss_dfl"):
        _close(aux[k].detach().numpy(), jaux[k])
    for got, want in ((r.grad, gr), (c.grad, gc)):
        want = np.asarray(want)
        rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert rel <= 1e-5, rel


def test_optax_sigmoid_bce_equals_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(0, 8, 1000).astype(np.float32)
    t = rng.uniform(0, 1, 1000).astype(np.float32)
    _close(pl.optax_sigmoid_bce(torch.from_numpy(x), torch.from_numpy(t)).numpy(),
           jax.jit(jl.optax_sigmoid_bce)(x, t))
