"""The gradient of the port's bf16 SiLU and sigmoid (``ops/act.py``)
against ``jax.vjp`` of flax's bf16 ``nn.silu`` and ``jax.nn.sigmoid``, at
every one of the 65,536 bf16 values of x, with output gradients at three
scales.

JAX differentiates ``logistic`` as ``s * (1 - s)``, and every op of the
VJP rounds to bf16.  XLA's CPU backend also flushes subnormal float32
results to zero; torch and the card keep them.  So the test holds two
things, each bit for bit (tolerance: none):

* the port's op sequence, run with that flush after each op, equals
  ``jax.vjp`` on every element (the ops and their roundings are JAX's);
* the port's gradient through autograd equals ``jax.vjp`` on every
  element where no flushed value arises (where the flushed and unflushed
  sequences agree: all but 3 to 18 of the 65,536 elements per scale,
  each with x at -76.5 or below).
"""

import operator

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litepi_tpu_torch.kernels import LAUNCHES
from litepi_tpu_torch.ops import act
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = 2.0 ** -126  # the smallest normal float32 (and bf16)


def _all_bf16():
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16)


def _op(f, *args):
    """One bf16 op as XLA's CPU program computes it: in float32, the
    subnormal result flushed, rounded to bf16, flushed again."""

    def flush(t):
        return torch.where(t.abs() < TINY, torch.zeros_like(t), t)

    return flush(flush(f(*[a.float() for a in args])).bfloat16())


def _sigmoid_flushed(x):
    e = _op(torch.exp, _op(operator.neg, x))
    return _op(lambda t: 1 / t, _op(lambda t: 1 + t, e))


def _grad_flushed(x, g, silu):
    x, g = _op(lambda t: t, x), _op(lambda t: t, g)
    s = _sigmoid_flushed(x)
    d = _op(operator.mul, s, _op(lambda t: 1 - t, s))
    if not silu:
        return _op(operator.mul, g, d)
    return _op(operator.add, _op(operator.mul, g, s), _op(operator.mul, _op(operator.mul, x, g), d))


def _grad_unflushed(x, g, silu):
    return act.silu_bf16_grad_plain(x, g) if silu else act.sigmoid_bf16_grad_plain(x, g)


def _same(a, b):
    a = a.float().numpy()
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)
    return (a == b) | (np.isnan(a) & np.isnan(b))


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "sigmoid"])
def test_bf16_vjp_equals_jax_at_every_bf16_value(silu):
    x = _all_bf16()
    jf = fnn.silu if silu else jax.nn.sigmoid
    vjp = jax.jit(lambda x, g: jax.vjp(jf, x)[1](g)[0])
    port_fn = act.silu if silu else act.sigmoid
    rng = np.random.default_rng(int(silu))
    before = dict(LAUNCHES)
    for scale in (1.0, 1e-3, 1e2):
        g = torch.from_numpy(rng.normal(0, scale, x.shape).astype(np.float32)).bfloat16()
        want = np.asarray(vjp(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                              jnp.asarray(g.float().numpy(), jnp.bfloat16)).astype(jnp.float32))
        flushed = _grad_flushed(x, g, silu)
        assert _same(flushed, want).all()
        xt = x.clone().requires_grad_(True)
        port_fn(xt).backward(g)
        assert xt.grad.dtype == torch.bfloat16
        got = xt.grad
        assert _same(got, _grad_unflushed(x, g, silu)).all()
        normal = _same(flushed, _grad_unflushed(x, g, silu))
        assert normal.sum() >= (1 << 16) - 40
        assert _same(got, want)[normal].all()
    assert LAUNCHES == before  # CPU tensors launch nothing


def test_forward_unchanged_without_autograd():
    """Without a gradient to record the forward is the plain passes, as
    before the autograd function existed; with one, the same values."""
    x = torch.from_numpy(np.random.default_rng(2).normal(0, 3, 4096).astype(np.float32)).bfloat16()
    for fn, plain in ((act.silu, act.silu_bf16_plain), (act.sigmoid, act.sigmoid_bf16_plain)):
        assert torch.equal(fn(x), plain(x))
        xt = x.clone().requires_grad_(True)
        y = fn(xt)
        assert y.grad_fn is not None and torch.equal(y.detach(), plain(x))


def test_float32_gradient_is_torchs():
    x = torch.linspace(-8, 8, 257, requires_grad=True)
    act.silu(x).sum().backward()
    want = torch.autograd.grad(torch.nn.functional.silu(x).sum(), x)[0]
    assert torch.equal(x.grad, want)
