"""``ops/resize.py`` (``jax.image.resize``'s antialiased bilinear) and the
ResNet-50 backbone (``models/resnet.py::ResNet50Backbone``) against the
JAX package on the CPU.

Tolerances: the resize within 1e-4 of 255 on uint8 frames at the
harnesses' shapes (2048x2048 -> 640x640, 1080x1920 -> 640x640, 640x640 ->
300x300); the backbone in float32 (eval and train mode: C2..C5 and the
updated ``batch_stats``) within 1e-4 relative to each tensor's largest
magnitude, on seeded variables whose BatchNorm is not the identity (train
mode in float64 on both sides, see its test).  In
bf16 each bottleneck, fed JAX's own bf16 input (JAX's program compiled
stepwise, ``xla_allow_excess_precision`` off, so that it rounds every op
as the port does), lies within the block's own bf16 drift ``max
|jax_bf16 - jax_f32|`` on that input, floored at the float32 tolerance,
and differs from JAX's bf16 output in at most 1% of its elements (0.46%
measured, most blocks bit-equal): the roundings match, and what remains
is the convolutions' summation order (tests/test_torch_faster_rcnn.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litepi_tpu.models.resnet import BottleneckBlock as JaxBlock
from litepi_tpu.models.resnet import ResNet50Backbone as JaxResNet50
from litepi_tpu_torch.models.resnet import ResNet50Backbone
from litepi_tpu_torch.ops.resize import resize_bilinear
from litepi_tpu_torch.weights.jax_bridge import jax_to_state_dict, state_dict_to_jax
from tests.torch_port_helpers import (
    assert_tree_equal,
    one_torch_thread,  # noqa: F401 (a fixture)
    random_jax_vars,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("src,dst", [((2048, 2048), (640, 640)), ((1080, 1920), (640, 640)),
                                     ((640, 640), (300, 300))])
def test_resize_matches_jax_image_resize(src, dst):
    frames = np.random.default_rng(0).integers(0, 256, (1, *src, 3), dtype=np.uint8)
    want = np.asarray(jax.jit(lambda f: jax.image.resize(
        f.astype(jnp.float32), (1, *dst, 3), "bilinear"))(frames))
    got = resize_bilinear(torch.from_numpy(frames), *dst).numpy()
    assert float(np.abs(got - want).max()) <= 1e-4 * 255


def test_resize_downscale_is_antialiased():
    """640 -> 300 is not F.interpolate without antialiasing (the
    letterbox's map): a 1-pixel checkerboard averages out."""
    frames = np.zeros((1, 640, 640, 1), np.uint8)
    frames[0, ::2, ::2] = frames[0, 1::2, 1::2] = 255
    got = resize_bilinear(torch.from_numpy(frames), 300, 300).numpy()
    assert float(np.abs(got - 127.5).max()) < 30


@pytest.fixture(scope="module")
def variables():
    return random_jax_vars(JaxResNet50(), seed=3, spatial=64)


@pytest.fixture()
def port(variables):
    m = ResNet50Backbone()
    m.load_state_dict(jax_to_state_dict(variables))
    return m


def _x(seed=0, size=64):
    return np.random.default_rng(seed).uniform(0, 1, (2, size, size, 3)).astype(np.float32)


def _nchw(x):
    x = np.asarray(x)
    return torch.from_numpy(x.astype(np.promote_types(x.dtype, np.float32))).permute(0, 3, 1, 2)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_float32_eval_matches_jax(variables, port):
    x = _x()
    want = jax.jit(lambda v, x: JaxResNet50().apply(v, x))(variables, x)
    with torch.no_grad():
        got = port.eval()(_nchw(x))
    for g, w in zip(got, want):
        assert _rel(g.permute(0, 2, 3, 1).numpy(), np.asarray(w)) <= 1e-4


def test_train_mode_matches_jax_in_float64(variables, port):
    """Train mode (batch statistics, flax's fast variance and momentum),
    C2..C5 and the updated ``batch_stats``, in float64 on both sides
    (JAX under ``jax_enable_x64``): in float32 the statistics of a B=2 batch
    amplify rounding noise layer by layer, and JAX's own float32 C5 stands
    1.2e-3 from float64 (the port's 4.2e-4), so float32 holds nothing here.
    Tolerance 1e-4 relative, as in float32 eval."""
    x = _x().astype(np.float64)
    v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
    jax.config.update("jax_enable_x64", True)
    try:
        want, mut = jax.jit(lambda v, x: JaxResNet50(dtype=jnp.float64).apply(
            v, x, train=True, mutable=["batch_stats"]))(v64, x)
        want = [np.asarray(w) for w in want]
        new_stats = jax.tree.map(np.asarray, mut["batch_stats"])
    finally:
        jax.config.update("jax_enable_x64", False)
    assert want[0].dtype == np.float64
    port = port.double().train()
    with torch.no_grad():
        got = port(_nchw(x).double())
    for g, w in zip(got, want):
        assert _rel(g.permute(0, 2, 3, 1).numpy(), w) <= 1e-4
    stats = state_dict_to_jax(port.state_dict())["batch_stats"]
    for path, w in jax.tree_util.tree_flatten_with_path(new_stats)[0]:
        g = stats
        for p in path:
            g = g[p.key]
        assert _rel(g, w) <= 1e-4, jax.tree_util.keystr(path)


@pytest.mark.parametrize("block", ["layer1_1", "layer2_0", "layer3_0", "layer4_0"])
def test_bf16_bottleneck_rounds_as_jax(variables, port, block):
    stage, idx = int(block[5]) - 1, int(block[7])
    width, stride = 64 * 2 ** stage, 2 if stage > 0 and idx == 0 else 1
    # the block's input: JAX's own bf16 activation there (stepwise program)
    m = JaxResNet50(dtype=jnp.bfloat16)
    x = _x(1)
    run = jax.jit(lambda v, x: m.apply(v, x, capture_intermediates=True,
                                       mutable=["intermediates"])).lower(variables, x).compile(
        compiler_options={"xla_allow_excess_precision": False})
    inter = run(variables, x)[1]["intermediates"]
    prev = {"layer1_1": "layer1_0", "layer2_0": "layer1_2", "layer3_0": "layer2_3",
            "layer4_0": "layer3_5"}[block]
    a = inter[prev]["__call__"][0]  # bf16
    vb = {"params": variables["params"][block], "batch_stats": variables["batch_stats"][block]}
    jb = JaxBlock(width, stride, dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(lambda v, a: jb.apply(v, a)).lower(vb, a).compile(
        compiler_options={"xla_allow_excess_precision": False})(vb, a), np.float32)
    f32 = np.asarray(jax.jit(lambda v, a: JaxBlock(width, stride).apply(v, a))(
        vb, np.asarray(a, np.float32)))
    mod = getattr(port.eval(), block)
    cast = {k: p.to(torch.bfloat16) for k, p in mod.named_parameters() if ".conv." in k}
    with torch.no_grad():
        got = torch.func.functional_call(mod, cast, (_nchw(a).bfloat16(),), strict=False)
    got = got.float().permute(0, 2, 3, 1).numpy()
    drift = float(np.abs(want - f32).max())
    assert float(np.abs(got - want).max()) <= max(drift, 1e-4 * float(np.abs(f32).max()))
    assert float((got != want).mean()) <= 0.01


def test_jax_bridge_round_trip(variables):
    assert_tree_equal(state_dict_to_jax(jax_to_state_dict(variables)),
                      jax.tree.map(lambda a: np.asarray(a, np.float32), variables))
