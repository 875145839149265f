"""bf16 SiLU and sigmoid as the JAX program rounds them (``ops/act.py``),
and the stem's bf16 rounding (``ops/stem.py::stem_plain``).

JAX writes flax's bf16 SiLU into its StableHLO as five bf16 ops (negate,
exp, add 1, divide, multiply) and ``jax.nn.sigmoid`` as the first four; the
port's plain versions round at each step and equal the jitted JAX ops on
every element, where torch's one-rounding ops differ in about a third of
them.  float32 stays on torch's ops.  The bf16 stem (a biased bf16 flax
conv, then SiLU) is bit-equal to JAX's on the same frames and weights.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from litepi_tpu_torch.kernels import LAUNCHES
from litepi_tpu_torch.models import YoloV5, YoloV11
from litepi_tpu_torch.models.layers import ConvBN
from litepi_tpu_torch.ops import act
from litepi_tpu_torch.ops.stem import stem_plain
from tests.torch_bf16_layers import op_checks
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_bf16_silu_and_sigmoid_round_as_jax():
    shares = op_checks(n=1 << 15)
    assert shares["silu: each step rounded"] == 0.0
    assert shares["sigmoid: each step rounded"] == 0.0
    assert shares["silu: one rounding"] > 0.2
    assert shares["sigmoid: one rounding"] > 0.2


def test_float32_and_cpu_dispatch():
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 3, 4096).astype(np.float32))
    assert torch.equal(act.silu(x), F.silu(x))
    assert torch.equal(act.sigmoid(x), torch.sigmoid(x))
    before = dict(LAUNCHES)
    b = x.bfloat16()
    for fn, plain in ((act.silu, act.silu_bf16_plain), (act.sigmoid, act.sigmoid_bf16_plain)):
        got = fn(b)
        assert got.dtype == torch.bfloat16 and torch.equal(got, plain(b))
    assert LAUNCHES == before  # CPU tensors launch nothing


def test_bf16_stem_rounds_as_jax_bf16_stem():
    """Canvas-sized uint8 frames through a biased bf16 flax conv (3x3/2,
    pad 1) and flax's SiLU, against ``stem_plain`` in bf16 on the same
    bf16-valued weights: every element equal."""
    rng = np.random.default_rng(0)
    c = 16
    frames = rng.integers(0, 256, (2, 80, 160, 3), dtype=np.uint8)
    k = np.asarray(jnp.asarray(rng.standard_normal((3, 3, 3, c)) / (255 * 27 ** 0.5),
                               jnp.bfloat16).astype(jnp.float32))
    b = np.asarray(jnp.asarray(rng.standard_normal(c) * 0.1, jnp.bfloat16).astype(jnp.float32))
    conv = fnn.Conv(c, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)), dtype=jnp.bfloat16)
    run = jax.jit(lambda x: fnn.silu(conv.apply({"params": {"kernel": k, "bias": b}},
                                                x.astype(jnp.bfloat16))))
    want = np.asarray(run(jnp.asarray(frames)).astype(jnp.float32))
    got = stem_plain(torch.from_numpy(frames), torch.from_numpy(k), torch.from_numpy(b),
                     torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_bf16_stem_sums_as_a_float32_conv():
    """The plain bf16 stem's tap-ordered sum is a float32 conv sum: within
    float32 noise of ``F.conv2d``, before its bf16 rounding."""
    from litepi_tpu_torch.ops.stem import _taps_in_order

    rng = np.random.default_rng(2)
    frames = torch.from_numpy(rng.integers(0, 256, (1, 80, 80, 3), dtype=np.uint8))
    k = torch.from_numpy((rng.standard_normal((3, 3, 3, 32)) / 255).astype(np.float32))
    want = F.conv2d(frames.permute(0, 3, 1, 2).float(), k.permute(3, 2, 0, 1), stride=2, padding=1)
    got = _taps_in_order(frames, k)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_silu_rounding_by_detector():
    """Every detector's ConvBN SiLU rounds at each step in bf16 but the
    anchor-free YOLOv5n's (models/yolov5.py; ROADMAP section 3)."""
    def acts(model):
        return {m.act for m in model.modules()
                if isinstance(m, ConvBN) and m.act in (act.silu, F.silu)}

    assert acts(YoloV11()) == {act.silu}
    assert acts(YoloV5()) == {act.silu}
    assert acts(YoloV5(anchor_free=True)) == {F.silu}


def test_bf16_reciprocal_rounds_alike_within_one_float32_ulp():
    """csrc/act.cu takes 1 / a from the hardware reciprocal (at most one
    float32 ulp off): for every bf16 value a >= 1, each float32 within one
    ulp of the IEEE quotient rounds to the same bf16 value."""
    a = torch.arange(0x3F80, 0x7F80, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    q = (1.0 / a.double()).float()
    want = q.bfloat16()
    for toward in (float("inf"), float("-inf")):
        near = torch.nextafter(q, torch.full_like(q, toward))
        assert torch.equal(near.bfloat16(), want)
