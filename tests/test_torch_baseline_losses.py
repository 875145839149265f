"""The baselines' losses and optimizers (``litepi_tpu_torch/train/
{ssd_loss,frcnn_loss,yolov5_loss,optim}.py``) against the JAX package's,
on random tensors made with numpy from a seed, in float32.

Tolerances: loss values within 1e-5 (relative where the value exceeds 1);
gradients (``torch.autograd`` against ``jax.grad``) within 1e-5 of each
gradient's largest element; discrete targets (sampling masks, matches,
target indices) equal; the Faster R-CNN loss fed JAX's own
``jax.random.uniform`` draws for the keys its ``frcnn_loss`` splits; the
optimizers' parameters after their steps within 1e-5 and the schedules
within 2.5e-7 of optax's (optax's float32 program as XLA rewrites it,
``train/optim.py``)."""

import jax
import numpy as np
import optax
import pytest
import torch

import litepi_tpu.train.frcnn_loss as jfl
import litepi_tpu.train.ssd_loss as jsl
import litepi_tpu.train.yolov5_loss as jyl
import litepi_tpu_torch.train.frcnn_loss as pfl
import litepi_tpu_torch.train.ssd_loss as psl
import litepi_tpu_torch.train.yolov5_loss as pyl
from litepi_tpu.models.faster_rcnn import rpn_anchors
from litepi_tpu.models.ssd import ssd_default_boxes
from litepi_tpu.ops.boxes import xywh_to_xyxy
from litepi_tpu_torch.train import optim
from litepi_tpu_torch.train.baselines import (
    AdamW,
    SGDMomentum,
    make_baseline_optimizer,
    step_lr_boundaries,
)
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-5


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale, float(np.abs(got - want).max())


def _t(x):
    return torch.from_numpy(np.array(x))


def _gt(rng, b, g, size, n_valid=(3, 1)):
    """Padded ground truth: boxes (B, G, 4) inside ``size``, labels in
    [0, 2), the first ``n_valid[i]`` slots of image i valid."""
    xy = rng.uniform(0, size * 0.7, (b, g, 2))
    wh = rng.uniform(size * 0.06, size * 0.3, (b, g, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.integers(0, 2, (b, g)).astype(np.int32)
    mask = np.arange(g)[None] < np.asarray(n_valid)[:, None]
    return boxes, labels, mask


# --------------------------------------------------------------------- #
# SSD multibox loss                                                     #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def ssd_inputs():
    rng = np.random.default_rng(0)
    db = ssd_default_boxes(300)
    db_xyxy = np.asarray(xywh_to_xyxy(db))
    n = db.shape[0]
    loc = rng.normal(0, 1, (2, n, 4)).astype(np.float32)
    conf = rng.normal(0, 2, (2, n, 3)).astype(np.float32)
    boxes, labels, mask = _gt(rng, 2, 4, 300)
    boxes[1, 1] = boxes[0, 0]  # a box two images share
    return loc, conf, db, db_xyxy, boxes, labels, mask


def test_multibox_loss_and_gradient_match_jax(ssd_inputs):
    loc, conf, db, db_xyxy, boxes, labels, mask = ssd_inputs

    def jloss(loc, conf):
        return jsl.multibox_loss({"loc": loc, "conf": conf}, db_xyxy, db, boxes, labels, mask)

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        loc, conf)
    tl, tc = _t(loc).requires_grad_(), _t(conf).requires_grad_()
    pl, paux = psl.multibox_loss({"loc": tl, "conf": tc}, _t(db_xyxy), _t(db), _t(boxes),
                                 _t(labels), _t(mask))
    pg = torch.autograd.grad(pl, (tl, tc))
    _close(pl.detach(), jl)
    for k in ("loss_loc", "loss_cls"):
        _close(paux[k].detach(), jaux[k])
    assert int(paux["num_pos"]) == int(jaux["num_pos"]) > 0
    for a, b in zip(pg, jg):
        _close(a, b, TOL * float(np.abs(b).max()))


def test_ssd_encode_and_forced_matches_match_jax(ssd_inputs):
    _, _, db, db_xyxy, boxes, _, mask = ssd_inputs
    want = np.asarray(jsl.encode_boxes(boxes, db[:4]))
    _close(psl.encode_boxes(_t(boxes), _t(db[:4])).numpy(), want)
    # a masked-off box writes False at its argmax 0, after a valid claim there
    iou = np.full((1, 3, 5), 0.1, np.float32)
    iou[0, 0, 0] = 0.9
    iou[0, 1, 3] = 0.8
    iou[0, 2] = -1.0
    forced, gt = psl.force_best_matches(_t(iou), _t(np.array([[True, True, False]])))
    assert forced.tolist() == [[False, False, False, True, False]]
    assert gt.tolist() == [[0, 0, 0, 1, 0]]


# --------------------------------------------------------------------- #
# Faster R-CNN losses                                                   #
# --------------------------------------------------------------------- #

def _jax_draws(key, a_shape, r_shape):
    """The four uniforms ``frcnn_loss(key)`` draws, in its split order."""
    k1, k2 = jax.random.split(key)
    k1a, k1b = jax.random.split(k1)
    k2a, k2b = jax.random.split(k2)
    return tuple(np.asarray(jax.random.uniform(k, s)) for k, s in
                 ((k1a, a_shape), (k1b, a_shape), (k2a, r_shape), (k2b, r_shape)))


@pytest.fixture(scope="module")
def frcnn_inputs():
    rng = np.random.default_rng(1)
    size, r, nc1 = 128, 32, 3
    anchors = rpn_anchors(size)
    a = anchors.shape[0]
    boxes, labels, mask = _gt(rng, 2, 4, size)
    props = np.concatenate([boxes[:, :2] + rng.normal(0, 3, (2, 2, 4)),
                            rng.uniform(0, size, (2, r - 2, 4))], 1).astype(np.float32)
    props[..., 2:] = np.maximum(props[..., 2:], props[..., :2] + 2)
    valid = np.ones((2, r), bool)
    valid[1, -5:] = False
    props[~valid] = 0.0
    out = {
        "rpn_obj": rng.normal(0, 2, (2, a)).astype(np.float32),
        "rpn_deltas": rng.normal(0, 0.5, (2, a, 4)).astype(np.float32),
        "anchors": anchors,
        "proposals": props,
        "proposal_valid": valid,
        "roi_cls": rng.normal(0, 2, (2, r, nc1)).astype(np.float32),
        "roi_reg": rng.normal(0, 0.5, (2, r, nc1, 4)).astype(np.float32),
    }
    return out, boxes, labels, mask, _jax_draws(jax.random.key(3), (2, a), (2, r))


FLOATS = ("rpn_obj", "rpn_deltas", "proposals", "roi_cls", "roi_reg")


def test_frcnn_loss_and_gradient_match_jax_with_jax_draws(frcnn_inputs):
    out, boxes, labels, mask, draws = frcnn_inputs

    def jloss(*floats):
        o = {**out, **dict(zip(FLOATS, floats))}
        return jfl.frcnn_loss(o, boxes, labels, mask, jax.random.key(3))

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, argnums=tuple(range(5)), has_aux=True))(
        *(out[k] for k in FLOATS))
    tf = {k: _t(out[k]).requires_grad_() for k in FLOATS}
    tout = {**{k: _t(v) for k, v in out.items()}, **tf}
    pl, paux = pfl.frcnn_loss(tout, _t(boxes), _t(labels), _t(mask), [_t(d) for d in draws])
    pg = torch.autograd.grad(pl, [tf[k] for k in FLOATS])
    _close(pl.detach(), jl)
    for k in ("rpn_obj_loss", "rpn_box_loss", "roi_cls_loss", "roi_box_loss"):
        _close(paux[k].detach(), jaux[k])
    for k in ("rpn_pos", "roi_pos"):
        assert int(paux[k]) == int(jaux[k]) > 0, k
    for k, a, b in zip(FLOATS, pg, jg):
        assert float(np.abs(np.asarray(b)).max()) > 0, k
        _close(a, b, TOL * float(np.abs(b).max()))


def test_subsample_mask_and_match_match_jax(frcnn_inputs):
    out, boxes, _, mask, draws = frcnn_inputs
    anchors = np.broadcast_to(out["anchors"], (2, *out["anchors"].shape))
    want = jfl._match(boxes, mask, anchors, 0.7, 0.3, True)
    got = pfl.match(_t(boxes), _t(mask), _t(anchors), 0.7, 0.3, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pos = np.asarray(want[0])
    key = jax.random.key(5)
    u = np.asarray(jax.random.uniform(key, pos.shape))
    for k in (1, 4, 128):
        np.testing.assert_array_equal(
            pfl.subsample_mask(_t(pos), k, _t(u)).numpy(),
            np.asarray(jfl.subsample_mask(pos, k, key)))


def test_frcnn_loss_takes_a_generator(frcnn_inputs):
    out, boxes, labels, mask, _ = frcnn_inputs
    tout = {k: _t(v) for k, v in out.items()}
    a = pfl.frcnn_loss(tout, _t(boxes), _t(labels), _t(mask), torch.Generator().manual_seed(0))
    b = pfl.frcnn_loss(tout, _t(boxes), _t(labels), _t(mask), torch.Generator().manual_seed(0))
    assert torch.isfinite(a[0]) and float(a[0]) == float(b[0])


# --------------------------------------------------------------------- #
# YOLOv5 (anchor-based) loss                                            #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def v5_inputs():
    rng = np.random.default_rng(2)
    size = 128
    _, a = jyl._level_tables(size)
    pred = rng.normal(0, 1.5, (2, a, 5 + 3)).astype(np.float32)
    boxes, labels, mask = _gt(rng, 2, 5, size, n_valid=(4, 2))
    boxes[0, 0] = [1.0, 1.0, 40.0, 30.0]  # a box at the grid's edge
    return pred, boxes, labels, mask, size


def test_build_targets_match_jax(v5_inputs):
    _, boxes, labels, mask, size = v5_inputs
    want = jax.jit(jyl.build_targets, static_argnums=3)(boxes, labels, mask, size)
    got = pyl.build_targets(_t(boxes), _t(labels), _t(mask), size)
    assert set(got) == set(want)
    for k in ("index", "valid", "level", "label"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("txy", "twh", "prior", "stride"):
        _close(got[k].numpy(), want[k])
    assert bool(got["valid"].any())


@pytest.mark.parametrize("nc", [3, 1])
def test_yolov5_loss_and_gradient_match_jax(v5_inputs, nc):
    pred, boxes, labels, mask, size = v5_inputs
    pred = pred[..., : 5 + nc]
    labels = labels % nc
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jyl.yolov5_loss(p, boxes, labels, mask, size), has_aux=True))(pred)
    tp = _t(pred).requires_grad_()
    pl, paux = pyl.yolov5_loss(tp, _t(boxes), _t(labels), _t(mask), size)
    (pg,) = torch.autograd.grad(pl, (tp,))
    _close(pl.detach(), jl)
    for k in ("loss_box", "loss_obj", "loss_cls"):
        _close(paux[k].detach(), jaux[k])
    assert int(paux["num_matched"]) == int(jaux["num_matched"]) > 0
    _close(pg, jg, TOL * float(np.abs(jg).max()))


# --------------------------------------------------------------------- #
# optimizers and schedules                                              #
# --------------------------------------------------------------------- #

def test_piecewise_constant_schedule_matches_optax():
    bounds = step_lr_boundaries(epochs=10, steps_per_epoch=4)
    assert bounds == {12: 0.1, 24: 0.1, 36: 0.1}
    want = optax.piecewise_constant_schedule(1e-4, bounds)
    got = optim.piecewise_constant_schedule(1e-4, bounds)
    for step in range(0, 45):
        w = float(want(step))
        assert abs(got(step) - w) <= 2.5e-7 * 1e-4, (step, got(step), w)
    assert step_lr_boundaries(epochs=2, steps_per_epoch=3) == {9: 0.1}


def _param_tree(rng):
    return {"a": rng.normal(0, 1, (5, 3)).astype(np.float32),
            "b": rng.normal(0, 1, (7,)).astype(np.float32)}


# the tests' weight decay: high enough that the decay term (lr * WD * |p|,
# 5e-4 a step at lr 1e-2) stands far above the 1e-5 tolerance
WD = 0.05


@pytest.mark.parametrize("which", ["sgd", "adamw"])
def test_baseline_optimizers_match_optax(which):
    """Four steps of each recipe's chain on random gradients, its weight
    decay raised to WD on both sides: the parameters within 1e-5 of
    optax's, and the same steps without the decay end at least 100x the
    tolerance away (the test sees a dropped or misplaced decay).  The
    recipes' own constants are the JAX CLI's: SGD momentum 0.9 with decay
    5e-4, AdamW with decay 1e-4."""
    rng = np.random.default_rng(4)
    params = _param_tree(rng)
    grads = [_param_tree(rng) for _ in range(4)]
    if which == "sgd":
        bounds = {2: 0.1}
        tx = optax.chain(optax.add_decayed_weights(WD),
                         optax.sgd(optax.piecewise_constant_schedule(1e-2, bounds),
                                   momentum=0.9))

        def port(wd):
            return SGDMomentum(optim.piecewise_constant_schedule(1e-2, bounds), weight_decay=wd)
        recipe = make_baseline_optimizer("faster_rcnn", 1e-2, 6, 2)
        assert (recipe.weight_decay, recipe.momentum) == (5e-4, 0.9)
    else:
        tx = optax.adamw(optax.cosine_decay_schedule(1e-2, 4), weight_decay=WD)

        def port(wd):
            return AdamW(optim.cosine_decay_schedule(1e-2, 4), weight_decay=wd)
        assert make_baseline_optimizer("ssd300", 1e-4, 30, 10).weight_decay == 1e-4
    jp, state = params, tx.init(params)
    for g in grads:
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
    ends = {}
    for wd in (WD, 0.0):
        ptx = port(wd)
        pp = [_t(params[k]) for k in sorted(params)]
        pstate = ptx.init(pp)
        for step, g in enumerate(grads):
            ptx.update_(pp, [_t(g[k]) for k in sorted(g)], pstate, step)
        ends[wd] = pp
    for k, p in zip(sorted(params), ends[WD]):
        np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]), atol=1e-5, rtol=1e-5)
    assert max(float((a - b).abs().max()) for a, b in zip(ends[WD], ends[0.0])) >= 100 * 1e-5


def test_adamw_on_the_ssd_loss_gradient_matches_optax(ssd_inputs):
    """One AdamW step (the SSD recipe's lr 1e-4, its weight decay raised
    to 0.5 on both sides so that the decay term, lr * 0.5 * |p|, shows)
    taking the SSD loss's gradient with respect to the head outputs as the
    parameters' gradient: parameters within 1e-5; the same step without
    the decay ends at least 10x the tolerance away."""
    loc, conf, db, db_xyxy, boxes, labels, mask = ssd_inputs
    params = {"conf": conf, "loc": loc}

    def jloss(p):
        return jsl.multibox_loss(p, db_xyxy, db, boxes, labels, mask)[0]

    g = jax.grad(jloss)(params)
    tx = optax.adamw(optax.cosine_decay_schedule(1e-4, 10), weight_decay=0.5)
    upd, _ = tx.update(g, tx.init(params), params)
    want = optax.apply_updates(params, upd)
    pp = {k: _t(v).requires_grad_() for k, v in params.items()}
    loss, _ = psl.multibox_loss(pp, _t(db_xyxy), _t(db), _t(boxes), _t(labels), _t(mask))
    keys = sorted(pp)
    grads = torch.autograd.grad(loss, [pp[k] for k in keys])
    ends = {}
    for wd in (0.5, 0.0):
        ptx = AdamW(optim.cosine_decay_schedule(1e-4, 10), weight_decay=wd)
        ends[wd] = [pp[k].detach().clone() for k in keys]
        ptx.update_(ends[wd], grads, ptx.init(ends[wd]), 0)
    for k, p in zip(keys, ends[0.5]):
        assert float(np.abs(p.numpy() - np.asarray(want[k])).max()) <= 1e-5, k
    assert max(float((a - b).abs().max()) for a, b in zip(ends[0.5], ends[0.0])) >= 10 * 1e-5
