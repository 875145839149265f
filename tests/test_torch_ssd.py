"""The port's SSD300 (``litepi_tpu_torch/models/ssd.py``) against the JAX
package's on the CPU: one forward at B=1 (the model is fixed at 300x300 by
its default-box grid), 2 foreground classes, seeded variables.

Tolerances: float32 ``loc`` / ``conf`` within 1e-4 relative to each
output's largest magnitude; the default boxes equal; the decode within
1e-6 relative.  The JAX ``SSD300(dtype=bf16)`` rounds its input to bf16
once and then computes in float32 (its convs carry no ``dtype``, so flax
promotes them to float32 from their parameters): checked here on the JAX
side (equal to the float32 model on the rounded input, and float32
outputs), and the port's bf16 model equals JAX's bf16 model within the
float32 tolerance.  The variables' bridge round trip is leaf-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import litepi_tpu.models.ssd as jssd
import litepi_tpu_torch.models.ssd as pssd
from litepi_tpu_torch.weights.jax_bridge import jax_to_state_dict, state_dict_to_jax
from tests.torch_port_helpers import (
    assert_tree_equal,
    one_torch_thread,  # noqa: F401 (a fixture)
    random_jax_vars,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NC = 2


@pytest.fixture(scope="module")
def variables():
    return random_jax_vars(jssd.SSD300(num_classes=NC), seed=5, spatial=300)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).uniform(0, 1, (1, 300, 300, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_out(variables, image):
    out = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        m = jssd.SSD300(num_classes=NC, dtype=dt)
        out[name] = jax.tree.map(np.asarray, jax.jit(lambda v, x: m.apply(v, x))(variables, image))
    rounded = np.asarray(jnp.asarray(image, jnp.bfloat16).astype(jnp.float32))
    m = jssd.SSD300(num_classes=NC)
    out["f32_on_rounded"] = jax.tree.map(np.asarray, jax.jit(lambda v, x: m.apply(v, x))(
        variables, rounded))
    return out


def _port(variables, image, dtype=torch.float32):
    m = pssd.SSD300(num_classes=NC, dtype=dtype)
    m.load_state_dict(jax_to_state_dict(variables))
    with torch.no_grad():
        return {k: v.numpy() for k, v in m.eval()(torch.from_numpy(image).permute(0, 3, 1, 2)).items()}


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_forward_float32_matches_jax(variables, image, jax_out):
    got = _port(variables, image)
    for k in ("loc", "conf"):
        assert got[k].shape == jax_out["f32"][k].shape
        assert _rel(got[k], jax_out["f32"][k]) <= 1e-4, k
    assert got["loc"].shape == (1, pssd.NUM_SSD_BOXES, 4)


def test_jax_bf16_ssd_is_float32_after_one_rounding(jax_out):
    for k in ("loc", "conf"):
        assert jax_out["bf16"][k].dtype == np.float32
        np.testing.assert_array_equal(jax_out["bf16"][k], jax_out["f32_on_rounded"][k])


def test_bf16_matches_jax_bf16(variables, image, jax_out):
    got = _port(variables, image, torch.bfloat16)
    for k in ("loc", "conf"):
        assert _rel(got[k], jax_out["bf16"][k]) <= 1e-4, k


def test_default_boxes_and_decode_match_jax():
    db = jssd.ssd_default_boxes(300)
    np.testing.assert_array_equal(pssd.ssd_default_boxes(300), db)
    loc = np.random.default_rng(1).normal(0, 2, (2, db.shape[0], 4)).astype(np.float32)
    want = np.asarray(jssd.decode_ssd_boxes(loc, db))
    got = pssd.decode_ssd_boxes(torch.from_numpy(loc), torch.from_numpy(db)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_jax_bridge_round_trip(variables):
    assert_tree_equal(state_dict_to_jax(jax_to_state_dict(variables)),
                      jax.tree.map(lambda a: np.asarray(a, np.float32), variables))
