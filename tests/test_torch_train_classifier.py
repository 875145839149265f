"""The port's classifier train step (``litepi_tpu_torch/train/
classifier.py``) against the JAX package's ``classifier_train_step``, and
the train-mode semantics it rests on (``models/layers.py``: flax's
BatchNorm, momentum 0.1 for the classifiers, MobileNetV2's and
EfficientNet-B0's dropout).

ShuffleNetV2, ResNet18 (integer and soft labels) and MobileNetV2 with
JAX's own dropout mask applied through a test-side module (the port draws
its masks from a torch generator, which cannot draw JAX's numbers), 10
classes, seeded variables, one step of Adam over the cosine schedule:

* in float64 on both sides (JAX with x64 on), where the step's arithmetic
  shows without float32's gradient noise: see
  ``test_float64_steps_equal_jax`` (``TOL64`` = 1e-6, the float32 Dense's
  rounding);
* ShuffleNetV2 in float32: the loss within 1e-5 relative, the accuracy
  equal, BatchNorm statistics within 1e-5 (absolute plus relative,
  elementwise), Adam's first moment and the parameters as ``_adam_close``
  says.  Float32 classifier gradients are noisy on both sides (a train-mode
  BatchNorm's fast variance cancels; ``python -m
  tests.test_torch_train_classifier`` prints each side's gap to JAX's
  float64 gradients), and Adam's first update is near sign(g), so where a
  gradient is float noise around 0 the two sides step apart by up to lr.

Serving is unchanged: a classifier in eval mode equals torch's own
BatchNorm2d forward bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litepi_tpu.models import build_classifier as jax_build
from litepi_tpu.train import classifier as jcls
from litepi_tpu_torch.models import build_classifier
from litepi_tpu_torch.models.layers import Dropout, batch_norm_train
from litepi_tpu_torch.train import classifier as pcls
from litepi_tpu_torch.weights.jax_bridge import jax_to_state_dict, state_dict_to_jax
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)
from tests.torch_port_helpers import random_jax_vars

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NC = 10


def _batch(seed, soft, S=64, B=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, S, S, 3)).astype(np.float32)
    hard = rng.integers(0, NC, B)
    if not soft:
        return {"images": x, "labels": hard.astype(np.int32)}
    w = rng.uniform(0.3, 0.7, B)[:, None]
    other = np.eye(NC)[rng.permutation(hard)]
    return {"images": x, "labels": (w * np.eye(NC)[hard] + (1 - w) * other).astype(np.float32)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float64)
    return out


def _elementwise(got, want, tol=1e-5):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=tol, atol=tol, err_msg=k)


# the float32 Dense's rounding, carried through float64 arithmetic
TOL64 = 1e-6


def _adam_close(params, want_params, mu, want_mu, steps, lr=1e-3, mu_tol=2e-3, tol=1e-5,
                share=5e-3):
    """Adam's first moment (the gradients' average) within ``mu_tol`` of
    JAX's in global relative L2 (float32: 2e-3, measured 4.9e-4), and the
    parameters within ``tol`` absolute plus relative elementwise, except a
    ``share`` of the elements (float32: 0.5%, measured 0.11% after one
    step), none of
    which may be further apart than 2 lr x steps (the most two Adam runs
    can move an element apart).  Adam's first updates are near sign(g): an
    element whose gradient is float noise around 0 steps by the noise's
    sign on each side, and float32 classifier gradients are noisy in places
    on both sides (``python -m tests.test_torch_train_classifier``: JAX's
    own float32 gradients stand up to 0.56% (ShuffleNetV2), 1.7% (ResNet18)
    and 22% (MobileNetV2) of a leaf's scale from its float64 ones)."""
    p, wp, m, wm = (_flat(t) for t in (params, want_params, mu, want_mu))
    num = sum(float(((m[k] - wm[k]) ** 2).sum()) for k in wm)
    den = sum(float((wm[k] ** 2).sum()) for k in wm)
    assert np.sqrt(num / den) <= mu_tol, np.sqrt(num / den)
    apart, total = 0, 0
    for k in wp:
        d = np.abs(p[k] - wp[k])
        assert (d <= 2 * lr * steps).all(), k
        apart += int((d > tol + tol * np.abs(wp[k])).sum())
        total += d.size
    assert apart <= share * total, (apart, total)


class JaxMask(torch.nn.Module):
    """Test-side stand-in for the port's ``Dropout``: JAX's keep mask of
    the current step, applied as flax applies it."""

    def __init__(self, rate):
        super().__init__()
        self.rate, self.mask = rate, None

    def forward(self, x):
        keep = torch.from_numpy(self.mask)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


def _jax_dropout_mask(model, variables, x, key):
    """JAX's dropout keep mask for ``classifier_train_step``'s forward with
    ``key``: where the Dropout's output is nonzero (an input of 0 gives 0
    either way)."""
    @jax.jit
    def run(variables, x, key):
        _, st = model.apply(variables, x, train=True, rngs={"dropout": key},
                            capture_intermediates=True, mutable=["batch_stats", "intermediates"])
        return st["intermediates"]["Dropout_0"]["__call__"][0]

    return np.asarray(run(variables, x, key)) != 0


def _run_steps(arch, soft, dtype, S, B, steps=1):
    """``steps`` steps of ``arch`` on both sides from the same seeded variables,
    in ``dtype`` (float32, or float64 with JAX's x64 on; the classifiers'
    Dense stays float32 on both sides, as the JAX models keep it).  Yields
    (JAX state, JAX metrics, port trees, port metrics) after each step."""
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    jmodel = jax_build(arch, NC, dtype=jnp.float64 if np_dt == np.float64 else jnp.float32)
    v = random_jax_vars(jax_build(arch, NC), seed=2, spatial=32)
    v["batch_stats"] = jax.tree.map(np.abs, v["batch_stats"])
    v = jax.tree.map(lambda a: a.astype(np_dt), v)
    tx = jcls.make_optimizer(1e-3, total_steps=10)
    jstate = jcls.ClassifierTrainState(v["params"], v["batch_stats"], tx.init(v["params"]),
                                       jnp.zeros((), jnp.int32))
    jstep = jax.jit(lambda s, b, k: jcls.classifier_train_step(jmodel, tx, s, b, k))

    model = build_classifier(arch, NC)
    state, ptx = pcls.create_classifier_train_state(model, lr=1e-3, total_steps=10,
                                                    dtype=dtype, device="cpu")
    model.load_state_dict(jax_to_state_dict(v))
    model.to(dtype).fc.float()
    state.opt_state = ptx.init(list(model.parameters()))
    mask = None
    if arch == "mobilenetv2":
        mask = model.dropout = JaxMask(0.2)
    names = [k for k, _ in model.named_parameters()]
    for i in range(steps):
        batch = {k: (a.astype(np_dt) if a.dtype.kind == "f" else a)
                 for k, a in _batch(i, soft, S, B).items()}
        key = jax.random.key(10 + i)
        if mask is not None:
            mask.mask = _jax_dropout_mask(
                jmodel, {"params": jstate.params, "batch_stats": jstate.batch_stats},
                batch["images"], key)
            assert 0 < mask.mask.mean() < 1
        jstate, jm = jstep(jstate, batch, key)
        tb = {"images": torch.from_numpy(batch["images"]).permute(0, 3, 1, 2),
              "labels": torch.from_numpy(batch["labels"])}
        state, m = pcls.classifier_train_step(model, ptx, state, tb)
        sd = model.state_dict()
        trees = {"vars": state_dict_to_jax(sd)}
        for moment in ("mu", "nu"):
            trees[moment] = state_dict_to_jax(
                {**sd, **dict(zip(names, state.opt_state[moment]))})["params"]
        yield jax.device_get(jstate), jax.device_get(jm), trees, m
    assert state.opt_state["count"] == steps == int(jstate.step)


@pytest.mark.parametrize("arch,soft", [("shufflenetv2", False), ("resnet18", True),
                                       ("mobilenetv2", True)])
def test_float64_steps_equal_jax(arch, soft):
    """The step's arithmetic, with float32's gradient noise out of the way:
    both sides in float64 (JAX with x64 on; the Dense float32 on both), at
    32x32, batch 4, one step: Adam's moments and BatchNorm statistics within
    ``TOL64`` (absolute plus relative), the parameters as ``_adam_close``
    holds them at ``TOL64`` (the Dense's float32 rounding still flips the
    sign of a gradient that is 0 up to it), the loss within ``TOL64``
    relative, the accuracy equal."""
    with jax.enable_x64(True):
        for jstate, jm, trees, m in _run_steps(arch, soft, torch.float64, S=32, B=4):
            assert abs(float(m["loss"]) - float(jm["loss"])) <= TOL64 * abs(float(jm["loss"]))
            assert float(m["accuracy"]) == float(jm["accuracy"])
            _elementwise(trees["vars"]["batch_stats"], jstate.batch_stats, TOL64)
            adam = jstate.opt_state[1][0]
            _elementwise(trees["mu"], adam.mu, TOL64)
            _elementwise(trees["nu"], adam.nu, TOL64)
            _adam_close(trees["vars"]["params"], jstate.params, trees["mu"], adam.mu,
                        int(jstate.step), mu_tol=TOL64, tol=TOL64, share=1e-3)


def test_float32_step_equals_jax():
    """ShuffleNetV2 (the shipped classifier), integer labels, one float32
    step at 64x64, batch 8 (one step: after it, the few elements whose
    Adam step took the sign of float noise move the next loss by ~4e-5
    relative): the loss within 1e-5 relative, the accuracy equal, BatchNorm statistics
    within 1e-5 and the parameters as ``_adam_close`` holds them."""
    for i, (jstate, jm, trees, m) in enumerate(
            _run_steps("shufflenetv2", False, torch.float32, S=64, B=8, steps=1)):
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        assert float(m["accuracy"]) == float(jm["accuracy"])
        _elementwise(trees["vars"]["batch_stats"], jstate.batch_stats)
        _adam_close(trees["vars"]["params"], jstate.params, trees["mu"],
                    jstate.opt_state[1][0].mu, i + 1)


@pytest.mark.parametrize("arch", ["shufflenetv2", "resnet18", "mobilenetv2", "efficientnet"])
def test_eval_mode_is_torchs_batchnorm(arch, monkeypatch):
    """Serving runs eval mode: every BatchNorm is a plain ``nn.BatchNorm2d``
    (momentum 0.1, flax's 0.9; eps 1e-5) called as it is, flax's train-mode
    BatchNorm never runs, and dropout is the identity; in train mode every
    BatchNorm goes through ``batch_norm_train``."""
    import litepi_tpu_torch.models.layers as layers
    import litepi_tpu_torch.models.resnet as resnet

    model = build_classifier(arch, NC)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and all(type(m) is torch.nn.BatchNorm2d and m.momentum == 0.1 and m.eps == 1e-5
                       for m in bns)
    calls = []

    def counted(bn, x):
        calls.append(bn)
        return batch_norm_train(bn, x)

    monkeypatch.setattr(layers, "batch_norm_train", counted)
    monkeypatch.setattr(resnet, "batch_norm_train", counted)
    x = torch.from_numpy(np.random.default_rng(5).normal(0, 1, (2, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        a = model.eval()(x)
        assert not calls and torch.equal(a, model(x))
        model.train()(x)
    assert len(calls) == len(bns)


def test_flax_batchnorm_train_semantics():
    """Train mode: flax's fast biased variance for the normalisation and the
    running variance (torch's running variance takes the unbiased one),
    the running averages at flax's momentum."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(0.5, 2.0, (3, 4, 5, 5)).astype(np.float32))
    bn = torch.nn.BatchNorm2d(4, eps=1e-5, momentum=0.1)
    y = batch_norm_train(bn, x)
    mean = x.double().mean((0, 2, 3))
    var = x.double().var((0, 2, 3), unbiased=False)
    want = (x.double() - mean[:, None, None]) / torch.sqrt(var + 1e-5)[:, None, None]
    assert torch.allclose(y.double(), want, atol=1e-5)
    assert torch.allclose(bn.running_mean.double(), 0.1 * mean, atol=1e-6)
    assert torch.allclose(bn.running_var.double(), 0.9 + 0.1 * var, atol=1e-6)


def test_dropout_draws_from_its_generator():
    d = Dropout(0.2).train()
    x = torch.ones(1000)
    a = d.__class__.forward(d, x)  # default generator
    d.generator = torch.Generator().manual_seed(7)
    b = d(x)
    d.generator = torch.Generator().manual_seed(7)
    assert torch.equal(b, d(x))
    assert set(torch.unique(b).tolist()) <= {0.0, 1.25} and 0.7 < float((b > 0).float().mean()) < 0.9
    assert a.shape == x.shape
    assert torch.equal(d.eval()(x), x)


def float64_gradient_gaps(arch, S=64):
    """(JAX float32, port float32): the worst leaf's gap to JAX's float64
    gradient, relative to the leaf's largest element or 1e-3 of the largest
    element of all leaves, whichever is larger (a BatchNorm bias followed,
    without an activation, by a conv and another BatchNorm has a gradient
    of 0 up to float noise), for the test's first
    batch in train mode (without dropout: MobileNetV2 and EfficientNet-B0
    train with it, so their rate is set to 0 on both sides)."""
    jax.config.update("jax_enable_x64", True)
    v = random_jax_vars(jax_build(arch, NC), seed=2, spatial=32)
    v["batch_stats"] = jax.tree.map(np.abs, v["batch_stats"])
    batch = _batch(0, arch != "shufflenetv2", S, 8)
    labels = batch["labels"] if batch["labels"].ndim == 2 else np.eye(NC)[batch["labels"]]

    def grads(dt):
        m = jax_build(arch, NC, dtype=dt)
        cast = jax.tree.map(lambda a: jnp.asarray(a, dt), v)

        def f(p):
            out, _ = m.apply({"params": p, "batch_stats": cast["batch_stats"]},
                             jnp.asarray(batch["images"], dt), train=True,
                             mutable=["batch_stats"], rngs={"dropout": jax.random.key(0)})
            return -(labels * jax.nn.log_softmax(out.astype(dt))).sum(-1).mean()

        return _flat(jax.grad(f)(cast["params"]))

    import flax.linen as fnn

    keep = fnn.Dropout.__call__
    fnn.Dropout.__call__ = lambda self, x, *a, **k: x
    try:
        g64, g32 = grads(jnp.float64), grads(jnp.float32)
    finally:
        fnn.Dropout.__call__ = keep
    model = build_classifier(arch, NC)
    model.load_state_dict(jax_to_state_dict(v))
    if hasattr(model, "dropout"):
        model.dropout.rate = 0.0
    out = model.train()(torch.from_numpy(batch["images"]).permute(0, 3, 1, 2))
    loss = -(torch.from_numpy(labels.astype(np.float32)) * torch.log_softmax(out, -1)).sum(-1).mean()
    loss.backward()
    gp = _flat(state_dict_to_jax({**model.state_dict(), **{k: p.grad for k, p in
                                                          model.named_parameters()}})["params"])
    top = max(np.abs(g).max() for g in g64.values())

    def gap(g):  # each leaf relative to its largest element, at least 1e-3 of the top
        return max(np.abs(g[k] - g64[k]).max() / max(np.abs(g64[k]).max(), 1e-3 * top)
                   for k in g64)

    return gap(g32), gap(gp)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for arch in ("shufflenetv2", "resnet18", "mobilenetv2"):
        jax_gap, port_gap = float64_gradient_gaps(arch)
        print(f"{arch}: worst gradient leaf against JAX float64: JAX float32 {jax_gap:.3g}, "
              f"port float32 {port_gap:.3g}")
