"""The port's YOLOv11n (litepi_tpu_torch/models/yolov11.py) against the JAX
package's on the same variables, carried through the weight bridge.

Float32 on the CPU.  The detector runs at v11n's full width (C2PSA with 2
heads of 64 channels, key_dim 32) on B=2 128x128 canvases; its head logits
are O(1) and compared at 2e-4 absolute (XLA's and oneDNN's convolutions sum
in different orders).  C2PSA alone, on a non-square token grid, at 1e-5.
BatchNorm statistics are perturbed so that every BN does work.  In
bfloat16, placed as TwoStagePipeline places an injected detector, the head
is held against JAX's bfloat16 YoloV11 at BF16_HEAD_ATOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litepi_tpu.models.init_utils import fast_init
from litepi_tpu.models.yolov11 import C2PSA as JaxC2PSA
from litepi_tpu.models.yolov11 import YoloV11 as JaxYoloV11
from litepi_tpu_torch.core.types import PipelineConfig
from litepi_tpu_torch.models import YoloV11, build_classifier
from litepi_tpu_torch.models.yolov11 import C2PSA
from litepi_tpu_torch.pipeline import TwoStagePipeline
from litepi_tpu_torch.weights import jax_to_state_dict
from tests.torch_port_helpers import perturb_batchnorm

HEAD_ATOL = 2e-4
# two bf16 spacings at the largest head logit of this input (~0.27)
BF16_HEAD_ATOL = 4e-3


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def v11():
    jvars = perturb_batchnorm(fast_init(JaxYoloV11(num_classes=1), seed=3), seed=4)
    model = YoloV11(num_classes=1)
    model.load_state_dict(jax_to_state_dict(jvars))
    return jvars, model.eval()


def test_yolov11_matches_jax(v11):
    jvars, model = v11
    x = np.random.default_rng(5).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: JaxYoloV11(num_classes=1).apply(v, x, train=False))(jvars, x)
    with torch.no_grad():
        got = model(_nchw(x))
    assert model.c2psa.m0.attn.num_heads == 2 and model.c2psa.m0.attn.key_dim == 32
    assert got["reg"].shape == (2, 16 * 16 + 8 * 8 + 4 * 4, 64)
    assert got["cls"].shape == (2, 336, 1)
    for k in ("reg", "cls"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=HEAD_ATOL, rtol=0)


def test_c2psa_matches_jax():
    """v11n's C2PSA (256 channels, 2 heads) on a 5x7 grid: the token order
    (row-major over h, w), the branch-major qkv split and the depthwise
    positional branch on V."""
    jvars = perturb_batchnorm(fast_init(JaxC2PSA(256), seed=6, spatial=8, channels=256), seed=7)
    x = np.random.default_rng(8).normal(0, 1, (2, 5, 7, 256)).astype(np.float32)
    want = np.asarray(JaxC2PSA(256).apply(jvars, x, train=False))
    block = C2PSA(256, 256)
    block.load_state_dict(jax_to_state_dict(jvars))
    with torch.no_grad():
        got = block.eval()(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_parameter_count_equals_jax(v11):
    jvars, model = v11
    n_jax = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(jvars["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert 1.8e6 < n_jax < 3.5e6  # v11n


def test_bfloat16_placed_as_jax(v11):
    """A bf16 pipeline keeps the injected detector's weights in bf16 but
    its BatchNorm in float32 with the state's values unrounded, as flax's
    BatchNorm (float32 ``param_dtype``) does, and the classifier's ``fc``
    float32 unrounded; the head then matches JAX's bf16 YoloV11 on the
    same variables."""
    jvars, _ = v11
    state = jax_to_state_dict(jvars)
    cls_state = build_classifier("shufflenetv2", 10).state_dict()
    cfg = PipelineConfig(det_input_size=128, num_classifier_classes=10)
    pipe = TwoStagePipeline(cfg, state, cls_state, torch.bfloat16, "cpu",
                            det_model=YoloV11(num_classes=1))
    placed = pipe.det_model.state_dict()
    n_bn = 0
    for name, m in pipe.det_model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            for k in ("weight", "bias", "running_mean", "running_var"):
                key = f"{name}.{k}"
                assert placed[key].dtype == torch.float32, key
                assert torch.equal(placed[key], state[key]), key
            n_bn += 1
        elif isinstance(m, torch.nn.Conv2d):
            assert m.weight.dtype == torch.bfloat16, name
    assert n_bn > 50
    assert pipe.cls_model.fc.weight.dtype == torch.float32
    assert torch.equal(pipe.cls_model.fc.weight, cls_state["fc.weight"])

    x = np.random.default_rng(5).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    want = jax.jit(
        lambda v, x: JaxYoloV11(num_classes=1, dtype=jnp.bfloat16).apply(v, x, train=False)
    )(jvars, x.astype(jnp.bfloat16))
    with torch.no_grad():
        got = pipe.det_model(_nchw(x).bfloat16())
    for k in ("reg", "cls"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k], np.float32),
                                   atol=BF16_HEAD_ATOL, rtol=0)


# YoloV11's state-dict keys and shapes (sha256 of "key:shape" lines in
# order) and its float64 head on a seeded input, recorded before the Detect
# head was factored out for YOLO12 (models/yolov11.py::add_detect_head)
V11_KEYS = (498, "f21d68dad4878d97d0301c87ff95d79d746477598b042018f7b9d6e0cd1aab8e")
V11_HEAD = {"reg": (-76.27299499511719, 775.8237915039062,
                    (-0.15521438419818878, 0.04203389212489128, -0.09804673492908478,
                     -0.02014162763953209)),
            "cls": (16.54243278503418, 16.54243278503418, (0.10527442395687103,))}


def test_yolov11_keys_and_output_unchanged_by_the_shared_head():
    import hashlib

    torch.manual_seed(0)
    model = YoloV11(num_classes=1)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(torch.rand(m.weight.shape, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
    state = model.state_dict()
    lines = "\n".join(f"{k}:{tuple(v.shape)}" for k, v in state.items())
    assert (len(state), hashlib.sha256(lines.encode()).hexdigest()) == V11_KEYS
    x = torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    with torch.no_grad():
        out = model.double().eval()(x)
    for k, (total, abs_total, picks) in V11_HEAD.items():
        v = out[k].double()
        assert float(v.sum()) == pytest.approx(total, rel=1e-6)
        assert float(v.abs().sum()) == pytest.approx(abs_total, rel=1e-6)
        np.testing.assert_allclose(v.reshape(-1)[::997][:len(picks)].numpy(), picks, rtol=1e-6)
