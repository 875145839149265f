"""The port's detector train step (``litepi_tpu_torch/train/detector.py``)
against the JAX package's ``detector_train_step``, on the CPU.

An ``ablation_configs`` detector (w 0.25, d 0.33, 3 classes) at 128x128,
batch 2, the same seeded variables and batch on both sides, the one-cycle
schedule (warmup 3 of 30 steps), float32 with one and three steps.
Tolerances: the loss within 1e-5 relative, and the step's discrete outputs
(``num_fg``) equal; parameters, BatchNorm statistics (flax's biased
variance) and the EMA within 1e-5 absolute plus 1e-5 relative
(elementwise; measured 8.7e-7 after three steps); the momentum trace, a
gradient-sized quantity, within 5e-4 of each leaf's largest element
(measured 9.0e-5 after one step, 1.5e-4 after three): JAX's own float32
gradients stand 7.0e-5 (relative, worst leaf) from its float64 gradients
on this net, the port's 6.8e-5 (``python -m
tests.test_torch_train_detector``), and three steps carry that through the
clip and the momentum.
The schedule equals optax's within 2.5e-7 of the peak rate at every step of
a 100-step run (XLA rewrites optax's float32 arithmetic, so a bit-equal
copy would copy XLA's rewrites; the port evaluates optax's formula).  A
bf16 step rounds as JAX's bf16 program does op for op (see
``test_bf16_step_rounds_as_jax_bf16`` for what XLA's excess precision
changes and the bounds).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from litepi_tpu.core.types import ablation_configs
from litepi_tpu.models import YoloLitePi as JaxYolo
from litepi_tpu.train import detector as jdet
from litepi_tpu_torch.core import types as T
from litepi_tpu_torch.models import YoloLitePi
from litepi_tpu_torch.train import detector as pdet
from litepi_tpu_torch.train.optim import warmup_cosine_decay_schedule
from litepi_tpu_torch.weights.jax_bridge import jax_to_state_dict, state_dict_to_jax
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)
from tests.torch_port_helpers import random_jax_vars

pytestmark = pytest.mark.usefixtures("one_torch_thread")

(CFG,) = ablation_configs(width_scales=(0.25,), depth_scales=(0.33,), extra=(), num_classes=3)
CFG = dataclasses.replace(CFG, input_size=128)
PCFG = T.DetectorConfig(**dataclasses.asdict(CFG))
TOTAL, WARMUP = 30, 3


def train_batch(seed=0, B=2, G=4, size=128):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (B, size, size, 3)).astype(np.float32)
    xy = rng.uniform(0, size - 40, (B, G, 2))
    boxes = np.concatenate([xy, np.minimum(xy + rng.uniform(12, 40, (B, G, 2)), size)], -1)
    mask = np.zeros((B, G), bool)
    mask[0, :3] = mask[1, :2] = True
    return {"images": imgs, "gt_boxes": boxes.astype(np.float32),
            "gt_labels": rng.integers(0, 3, (B, G)).astype(np.int32), "gt_mask": mask}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float64)
    return out


def jax_state(dtype):
    """The JAX model, train state and optimizer on seeded variables."""
    model = JaxYolo(CFG, dtype=dtype)
    v = random_jax_vars(JaxYolo(CFG), seed=0, spatial=64)
    v["batch_stats"] = jax.tree.map(lambda a: np.abs(a), v["batch_stats"])
    tx = jdet.make_optimizer(1e-2, total_steps=TOTAL, warmup_steps=WARMUP)
    state = jdet.DetectorTrainState(
        params=v["params"], batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
        step=jnp.zeros((), jnp.int32), ema_params=v["params"])
    return model, state, tx, v


def port_state(v, dtype):
    model, state, tx = pdet.create_detector_train_state(
        PCFG, lr=1e-2, dtype=dtype, total_steps=TOTAL, warmup_steps=WARMUP, device="cpu")
    model.load_state_dict(jax_to_state_dict(v))
    state.ema_params = {k: p.detach().clone() for k, p in model.named_parameters()}
    return model, state, tx


@pytest.fixture(scope="module")
def f32_runs():
    """Three float32 steps on both sides: [(JAX state, JAX metrics, port
    trees, port metrics)] after each step."""
    jmodel, jstate, jtx, v = jax_state(jnp.float32)
    jstep = jax.jit(lambda s, b: jdet.detector_train_step(jmodel, jtx, s, b, cfg=CFG))
    model, state, tx = port_state(v, torch.float32)
    names = [k for k, _ in model.named_parameters()]
    runs = []
    for i in range(3):
        batch = train_batch(seed=i)
        jstate, jm = jstep(jstate, batch)
        state, m = pdet.detector_train_step(
            model, tx, state, pdet.to_device_batch(batch, torch.device("cpu")), cfg=PCFG)
        sd = model.state_dict()
        trees = {
            "vars": state_dict_to_jax(sd),
            "ema": state_dict_to_jax({**sd, **state.ema_params})["params"],
            "trace": state_dict_to_jax({**sd, **dict(zip(names, state.opt_state["trace"]))})[
                "params"],
        }
        runs.append((jax.device_get(jstate), jax.device_get(jm), trees,
                     {k: float(t) for k, t in m.items()}))
    return runs


def _elementwise(got, want, tol=1e-5):
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("steps", [1, 3])
def test_float32_steps_equal_jax(f32_runs, steps):
    jstate, jm, trees, m = f32_runs[steps - 1]
    assert abs(m["loss"] - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    assert m["num_fg"] == int(jm["num_fg"]) > 0
    for k in ("loss_box", "loss_cls", "loss_dfl"):
        assert abs(m[k] - float(jm[k])) <= 1e-5 * max(1.0, abs(float(jm[k]))), k
    _elementwise(trees["vars"]["params"], jstate.params)
    _elementwise(trees["vars"]["batch_stats"], jstate.batch_stats)
    _elementwise(trees["ema"], jstate.ema_params)
    jt, pt = flat(jstate.opt_state[2][0].trace), flat(trees["trace"])
    for k in jt:
        scale = max(np.abs(jt[k]).max(), 1e-12)
        assert np.abs(pt[k] - jt[k]).max() <= 5e-4 * scale, k


def test_schedule_equals_optax():
    for lr, total, warm in ((1e-2, 100, 30), (1e-2, 100, 3), (2e-2, 57, 9)):
        want = jax.jit(jdet.make_lr_schedule(lr, total, warm))
        got = pdet.make_lr_schedule(lr, total, warm)
        for step in range(total + 3):
            assert abs(got(step) - float(want(jnp.int32(step)))) <= 2.5e-7 * lr, (lr, step)
    want = jax.jit(optax.cosine_decay_schedule(1e-3, decay_steps=100))
    from litepi_tpu_torch.train.classifier import make_optimizer

    got = make_optimizer(1e-3, 100).schedule
    for step in range(103):
        assert abs(got(step) - float(want(jnp.int32(step)))) <= 2.5e-7 * 1e-3, step
    direct = warmup_cosine_decay_schedule(1e-3, 1e-2, 30, 100, 1e-4)
    assert direct(30) == pytest.approx(1e-2, rel=1e-7)


def test_bf16_step_rounds_as_jax_bf16():
    """A bf16 step on each of the three batches, from the same variables.

    The port rounds every bf16 op, as JAX's program does op for op with
    XLA's ``xla_allow_excess_precision`` off.  With it on (XLA's default)
    fused elementwise chains (a train-mode BatchNorm into its SiLU) skip
    some bf16 roundings, and JAX's bf16 head outputs drift from float32
    by about 0.6x as much.  Held, on each batch: the port's bf16 head
    outputs (reg, cls) drift from its float32 ones by no more than 1.3x
    the RMS drift of JAX's stepwise program (measured 0.98-1.17x), and by
    at most 2x that of JAX's default program (measured 1.05-1.7x); the
    port's float32 loss within 1e-5 relative of JAX's float32 loss.  The
    step's loss: its relative drift from the float32 loss, as an RMS over
    the three batches, no more than 1.3x that of JAX's stepwise program
    (measured 0.217% against 0.233%, 0.93x).  Batch by batch the port's
    loss drifts 0.185%, 0.222% and 0.240%, JAX's stepwise program's
    0.111%, 0.217% and 0.321% (1.67x, 1.02x, 0.75x), and JAX's train
    step compiled with XLA's defaults 0.0007%, 0.149% and 0.173%: a
    scalar's bf16 drift is one draw of the rounding noise summed over the
    loss's terms, which JAX's two programs place 150x apart on the first
    batch, so a single batch cannot be held at a factor (ROADMAP section
    3)."""
    from litepi_tpu.ops.anchors import make_anchors
    from litepi_tpu.train.losses import detection_loss as jax_detection_loss
    from litepi_tpu_torch.train.losses import detection_loss

    _, _, _, v = jax_state(jnp.bfloat16)
    anchors, strides = (jnp.asarray(a) for a in make_anchors(CFG.input_size, CFG.strides))

    def program(dtype, excess=True):
        """JAX's train-mode forward and its loss, compiled as one program."""
        m = JaxYolo(CFG, dtype=dtype)

        def f(b):
            out = m.apply(v, b["images"], train=True, mutable=["batch_stats"])[0]
            loss, _ = jax_detection_loss(out, anchors, strides, b["gt_boxes"], b["gt_labels"],
                                         b["gt_mask"], reg_max=CFG.reg_max)
            return out, loss

        return jax.jit(f).lower(train_batch(0)).compile(
            compiler_options={"xla_allow_excess_precision": excess})

    j16_default, j16_stepwise = program(jnp.bfloat16), program(jnp.bfloat16, False)
    j32 = program(jnp.float32)
    ref = YoloLitePi(PCFG)
    ref.load_state_dict(jax_to_state_dict(v))
    p_anchors, p_strides = (torch.from_numpy(np.asarray(a)) for a in (anchors, strides))

    def rms(a, b):
        a, b = (np.asarray(t, np.float32).astype(np.float64) for t in (a, b))
        return float(np.sqrt(np.mean((a - b) ** 2)))

    port_drift, jax_drift = [], []
    for i in range(3):
        batch = train_batch(seed=i)
        tb = pdet.to_device_batch(batch, torch.device("cpu"))
        with torch.no_grad():
            p32 = pdet.forward_in(ref.train(), torch.float32, tb["images"])
            loss32, _ = detection_loss(p32, p_anchors, p_strides, tb["gt_boxes"],
                                       tb["gt_labels"], tb["gt_mask"], reg_max=PCFG.reg_max)
        model, state, tx = port_state(v, torch.bfloat16)
        outs = {}
        hook = model.head.register_forward_hook(lambda m, i, o: outs.update(o))
        state, m = pdet.detector_train_step(model, tx, state, tb, cfg=PCFG)
        hook.remove()
        (want32, jloss32), (stepwise, jloss16) = j32(batch), j16_stepwise(batch)
        default = j16_default(batch)[0]
        for k in ("reg", "cls"):
            port = rms(outs[k].detach().float(), p32[k])
            assert 0 < port <= 1.3 * rms(stepwise[k], want32[k]), (i, k)
            assert port <= 2.0 * rms(default[k], want32[k]), (i, k)
        jloss32, loss32 = float(jloss32), float(loss32)
        assert abs(loss32 - jloss32) <= 1e-5 * jloss32, i
        port_drift.append(abs(float(m["loss"]) - loss32) / loss32)
        jax_drift.append(abs(float(jloss16) - jloss32) / jloss32)
        assert all(torch.isfinite(p).all() for p in model.parameters())
        assert all(p.dtype == torch.float32 for p in model.parameters())  # float32 masters
    rms_port, rms_jax = (float(np.sqrt(np.mean(np.square(d)))) for d in (port_drift, jax_drift))
    assert 0 < rms_port <= 1.3 * rms_jax, (port_drift, jax_drift)


def test_flax_init_distributions():
    """``create_detector_train_state``'s weights: conv kernels truncated at
    two standard deviations of variance 1 / fan_in (flax's lecun normal),
    BatchNorm at its identity, the EMA equal to the parameters."""
    model, state, _ = pdet.create_detector_train_state(PCFG, seed=3, device="cpu")
    w = torch.cat([m.weight.detach().flatten() * m.weight[0].numel() ** 0.5 for m in model.modules()
                   if isinstance(m, torch.nn.Conv2d)])
    assert w.abs().max() <= 2 / 0.87962566103423978 + 1e-6
    assert abs(float(w.std()) - 1.0) < 0.02
    for k, p in model.named_parameters():
        assert torch.equal(state.ema_params[k], p)
    again, _, _ = pdet.create_detector_train_state(PCFG, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again.state_dict().values(),
                                                   model.state_dict().values()))


def float64_gradient_gaps():
    """(JAX float32, port float32) worst relative gap of a gradient leaf to
    JAX's float64 gradient, on the test's net and first batch (a loss
    that weighs every head output)."""
    jax.config.update("jax_enable_x64", True)
    v = random_jax_vars(JaxYolo(CFG), seed=0, spatial=64)
    v["batch_stats"] = jax.tree.map(lambda a: np.abs(a), v["batch_stats"])
    x = train_batch(0)["images"]
    rng = np.random.default_rng(1)
    A = PCFG.num_anchors
    wr, wc = rng.normal(0, 1, (2, A, 64)), rng.normal(0, 1, (2, A, 3))

    def grads(dt):
        m = JaxYolo(CFG, dtype=dt)
        cast = jax.tree.map(lambda a: jnp.asarray(a, dt), v)

        def f(p):
            out, _ = m.apply({"params": p, "batch_stats": cast["batch_stats"]},
                             jnp.asarray(x, dt), train=True, mutable=["batch_stats"])
            return (out["reg"] * wr.astype(dt)).sum() + (out["cls"] * wc.astype(dt)).sum()

        return flat(jax.grad(f)(cast["params"]))

    g64, g32 = grads(jnp.float64), grads(jnp.float32)
    pm = YoloLitePi(PCFG)
    pm.load_state_dict(jax_to_state_dict(v))
    out = pm.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    loss = (out["reg"] * torch.from_numpy(wr.astype(np.float32))).sum() + (
        out["cls"] * torch.from_numpy(wc.astype(np.float32))).sum()
    loss.backward()
    gp = flat(state_dict_to_jax({**pm.state_dict(), **{k: p.grad for k, p in
                                                      pm.named_parameters()}})["params"])
    gap = lambda g: max(np.abs(g[k] - g64[k]).max() / np.abs(g64[k]).max() for k in g64)  # noqa
    return gap(g32), gap(gp)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax_gap, port_gap = float64_gradient_gaps()
    print(f"worst gradient leaf against JAX float64: JAX float32 {jax_gap:.3g}, "
          f"port float32 {port_gap:.3g}")
