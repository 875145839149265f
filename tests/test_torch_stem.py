"""The stem (litepi_tpu_torch/ops/stem.py, the counterpart of
litepi_tpu/ops/pallas_stem.py) against the JAX package on the CPU.

``stem_plain`` is held to ``pallas_stem`` run in interpret mode, the way
tests/test_pallas_stem.py runs it, at that file's tolerance (1e-4 on
float32: both sum 27 float32 products, in other orders).  On the CPU
``fused_stem`` takes the plain version; the kernel itself is held to it on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litepi_tpu.ops.pallas_stem import pallas_stem
from litepi_tpu.weights.fold_bn import fold_detector_pipeline_vars
from litepi_tpu.weights.fold_bn import fold_stem_input as jax_fold_stem
from litepi_tpu_torch.kernels import LAUNCHES
from litepi_tpu_torch.kernels.stem import pack_stem_params
from litepi_tpu_torch.ops.stem import fused_stem, stem_plain
from litepi_tpu_torch.weights import fold_batchnorm, jax_to_state_dict, stem_kernel_hwio
from litepi_tpu_torch.pipeline import TwoStagePipeline
from tests.torch_port_helpers import SMALL, jax_init_vars, perturb_batchnorm, port_config


def _inputs(seed, shape, c_out):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, shape, dtype=np.uint8)
    kernel = (rng.standard_normal((3, 3, 3, c_out)) * 0.05 / 255).astype(np.float32)
    bias = (rng.standard_normal(c_out) * 0.1).astype(np.float32)
    return frames, kernel, bias


@pytest.mark.parametrize("use_mxu", [True, False])
@pytest.mark.parametrize("shape", [(2, 160, 160, 3), (1, 80, 240, 3)])
@pytest.mark.parametrize("c_out", [16, 32])
def test_stem_plain_matches_pallas_stem(use_mxu, shape, c_out):
    frames, kernel, bias = _inputs(c_out + shape[2], shape, c_out)
    want = np.asarray(
        pallas_stem(
            jnp.asarray(frames), jnp.asarray(kernel), jnp.asarray(bias),
            interpret=True, use_mxu=use_mxu, out_dtype=jnp.float32,
        )
    )
    got = stem_plain(
        torch.from_numpy(frames), torch.from_numpy(kernel), torch.from_numpy(bias),
        torch.float32,
    )
    assert got.shape == want.shape == (shape[0], shape[1] // 2, shape[2] // 2, c_out)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_fused_stem_on_the_cpu_is_the_plain_version():
    """CPU tensors take stem_plain (no launch); the result is a (B, H/2,
    W/2, C) view of NCHW memory, in the asked dtype."""
    frames, kernel, bias = (torch.from_numpy(a) for a in _inputs(3, (2, 80, 160, 3), 16))
    before = dict(LAUNCHES)
    for dtype in (torch.float32, torch.bfloat16):
        got = fused_stem(frames, kernel, bias, dtype)
        assert got.dtype == dtype and got.shape == (2, 40, 80, 16)
        assert got.permute(0, 3, 1, 2).is_contiguous()
        assert torch.equal(got, stem_plain(frames, kernel, bias, dtype))
    assert LAUNCHES == before


@pytest.mark.parametrize("hw", [(100, 160), (120, 240), (80, 161)])
def test_frame_size_contract(hw):
    """pallas_stem refuses H % 80 != 0 and odd W; so does the port."""
    frames, kernel, bias = (torch.from_numpy(a) for a in _inputs(0, (1, *hw, 3), 16))
    with pytest.raises(ValueError, match="not supported"):
        fused_stem(frames, kernel, bias, torch.float32)
    with pytest.raises(ValueError, match="not supported"):
        pallas_stem(jnp.asarray(frames.numpy()), jnp.asarray(kernel.numpy()),
                    jnp.asarray(bias.numpy()), interpret=True)


def test_fused_stem_rejects_other_frames():
    _, kernel, bias = (torch.from_numpy(a) for a in _inputs(0, (1, 80, 80, 3), 16))
    with pytest.raises(ValueError, match="uint8"):
        fused_stem(torch.zeros((1, 80, 80, 3)), kernel, bias)
    with pytest.raises(ValueError, match="uint8"):
        fused_stem(torch.zeros((1, 80, 80, 4), dtype=torch.uint8), kernel, bias)


@pytest.mark.parametrize("flip", [False, True])
def test_stem_kernel_hwio_matches_the_jax_fold(flip):
    """The folded HWIO stem kernel equals the JAX fold (BN fold, then
    fold_stem_input at 1/255 with the BGR flip) bit for bit, on the SMALL
    detector's variables with random BatchNorm statistics."""
    det, _ = jax_init_vars(SMALL, seed=0)
    det = perturb_batchnorm(det, seed=2)
    folded, _ = fold_detector_pipeline_vars(det)
    raw = jax_fold_stem(folded, 1.0 / 255.0, flip)
    want = np.asarray(raw["params"]["backbone"]["stem"]["conv"]["kernel"])
    state = fold_batchnorm(jax_to_state_dict(det))
    got = stem_kernel_hwio(state["backbone.stem.conv.weight"], flip)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    # the kernel pallas_stem takes: its (27, C) reshape is the tap order
    assert got.reshape(27, -1).shape == (27, SMALL.detector.channels[0])


@pytest.mark.parametrize("flip", [False, True])
def test_packed_stem_params_are_the_fold_in_tap_order(flip):
    """The stem kernel's parameter block (pack_stem_params): rows 0-26 the
    HWIO fold (weights/fold_bn.py::stem_kernel_hwio) reshaped to (27, C) in
    (dy, dx, ci) order, row 27 the folded bias, bit for bit against numpy
    and against the JAX package's fold."""
    det, _ = jax_init_vars(SMALL, seed=0)
    det = perturb_batchnorm(det, seed=3)
    folded, _ = fold_detector_pipeline_vars(det)
    raw = jax_fold_stem(folded, 1.0 / 255.0, flip)["params"]["backbone"]["stem"]["conv"]
    state = fold_batchnorm(jax_to_state_dict(det))
    hwio = stem_kernel_hwio(state["backbone.stem.conv.weight"], flip)
    c = hwio.shape[-1]
    bias = state["backbone.stem.conv.bias"]
    packed = pack_stem_params(hwio.reshape(27, c), bias)
    assert packed.dtype == torch.float32 and packed.shape == (28, c)
    assert packed.device.type == "cpu" and packed.is_contiguous()
    want = np.concatenate([hwio.numpy().reshape(27, c), bias.numpy()[None]])
    np.testing.assert_array_equal(packed.numpy(), want)
    for dy in range(3):
        for dx in range(3):
            for ci in range(3):
                np.testing.assert_array_equal(
                    packed[(dy * 3 + dx) * 3 + ci].numpy(), np.asarray(raw["kernel"])[dy, dx, ci]
                )
    np.testing.assert_array_equal(packed[27].numpy(), np.asarray(raw["bias"]))


@pytest.mark.parametrize("input_color", ["rgb", "bgr"])
def test_pipeline_packs_its_stem_params_once(input_color):
    """TwoStagePipeline packs the stem kernel's parameter block when it
    folds its stem: the host copy of the kernel and bias it holds."""
    det, clf = jax_init_vars(SMALL, seed=0)
    cfg = port_config(dataclasses.replace(SMALL, input_color=input_color))
    pipe = TwoStagePipeline.from_jax_vars(cfg, det, clf, device="cpu")
    c = pipe._stem_kernel.shape[-1]
    assert pipe._stem_params.device.type == "cpu"
    np.testing.assert_array_equal(
        pipe._stem_params.numpy(),
        np.concatenate([pipe._stem_kernel.numpy().reshape(27, c), pipe._stem_bias.numpy()[None]]),
    )


def test_fused_stem_on_the_cpu_ignores_params():
    """On CPU tensors the plain version runs, with or without the packed
    parameter block."""
    frames, kernel, bias = (torch.from_numpy(a) for a in _inputs(5, (1, 80, 80, 3), 16))
    params = pack_stem_params(kernel.reshape(27, 16), bias)
    assert torch.equal(fused_stem(frames, kernel, bias, torch.float32, params),
                       stem_plain(frames, kernel, bias, torch.float32))
