"""The port's ResNet18, MobileNetV2 and EfficientNet-B0
(litepi_tpu_torch/models/{resnet,mobilenetv2,efficientnet}.py) against the
JAX package's on the same variables, unfused and deploy-form, and the
port's BatchNorm fold against the JAX fold, bit for bit.

Float32 on the CPU, 5 normal-distributed 64x64 crops, 10 classes,
BatchNorm statistics perturbed; softmax probabilities compared at 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from litepi_tpu.models import build_classifier as jax_build_classifier
from litepi_tpu.models.init_utils import fast_init
from litepi_tpu.weights.fold_bn import fold_batchnorm as jax_fold
from litepi_tpu_torch.models import build_classifier
from litepi_tpu_torch.models.layers import CLASSIFIER_BN_EPS
from litepi_tpu_torch.weights import fold_batchnorm, jax_to_state_dict
from tests.torch_port_helpers import perturb_batchnorm

ARCHS = ("resnet18", "mobilenetv2", "efficientnet")


@pytest.fixture(scope="module", params=ARCHS)
def arch_vars(request):
    arch = request.param
    jvars = fast_init(jax_build_classifier(arch, 10), seed=ARCHS.index(arch), spatial=64)
    return arch, perturb_batchnorm(jvars, seed=9, spread=0.05)


@pytest.mark.parametrize("fused", [False, True])
def test_classifier_probs_match_jax(arch_vars, fused):
    arch, jvars = arch_vars
    x = np.random.default_rng(7).normal(0, 1, (5, 64, 64, 3)).astype(np.float32)
    v = jax_fold(jvars, eps=CLASSIFIER_BN_EPS) if fused else jvars
    apply = jax.jit(lambda v, x: jax_build_classifier(arch, 10, fused=fused).apply(
        v, x, train=False))
    want = np.asarray(jax.nn.softmax(apply(v, x), axis=-1))
    state = jax_to_state_dict(jvars)
    if fused:
        state = fold_batchnorm(state, CLASSIFIER_BN_EPS)
    model = build_classifier(arch, 10, fused=fused)
    model.load_state_dict(state)
    with torch.no_grad():
        got = torch.softmax(model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)), -1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_fold_is_bit_equal_to_jax(arch_vars):
    """Port fold on the bridged state == bridge of the JAX fold, every key
    and every bit; ResNet18's root ``conv1``/``bn1`` pair folds too."""
    arch, jvars = arch_vars
    a = fold_batchnorm(jax_to_state_dict(jvars), CLASSIFIER_BN_EPS)
    b = jax_to_state_dict(jax_fold(jvars, eps=CLASSIFIER_BN_EPS))
    assert set(a) == set(b)
    assert not any("running" in k or ".bn" in k or k.startswith("bn") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    if arch == "resnet18":
        assert "conv1.bias" in a and "bn1.weight" not in a


def test_fold_rejects_a_batchnorm_without_its_conv():
    state = {"x.bn.weight": torch.ones(2), "x.bn.bias": torch.zeros(2),
             "x.bn.running_mean": torch.zeros(2), "x.bn.running_var": torch.ones(2)}
    with pytest.raises(ValueError, match="no conv sibling"):
        fold_batchnorm(state)
