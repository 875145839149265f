"""YOLOv9-E on the card (``gpu``; skips without one): the pipeline's bf16
deployed form sends each of its 48 folded RepConvs through the act kernel's
bias mode and every other ConvBN through its BatchNorm mode, fuses 5 times
per forward, runs channels last from its weights to every conv's and
fan-in's output, and does so inside ``run_fused``; the other injected
detectors bring no deployed form and run as given.  The ADown front-end
kernel (``kernels/adown.py``) is bit-equal to ATen's chain on the card at
the cell's ADown shapes, at odd sizes and with NaN and infinities, writes
both halves dense, raises on what it does not take, and runs 8 times per
``run_fused`` without moving a bit of its outputs.  Imports neither JAX nor
the test helpers, so that it runs on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_yolov9_cuda.py``."""

import pytest
import torch

from litepi_tpu_torch.core.types import DetectorConfig, PipelineConfig
from litepi_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from litepi_tpu_torch.kernels.adown import (
    adown_front_cuda,
    adown_front_plain,
    takes_adown_kernel,
)
from litepi_tpu_torch.models import yolov9
from litepi_tpu_torch.models.layers import ConvBN
from litepi_tpu_torch.models.registry import DETECTOR_VARIANTS, detector_kwargs
from litepi_tpu_torch.pipeline import TwoStagePipeline

SIZE = 256
REPCONVS = 48
ADOWNS = 8
# the ADown inputs of the YOLOv9-E cell (1280 input), at B=2
ADOWN_SHAPES = ((2, 256, 320, 320), (2, 512, 160, 160), (2, 1024, 80, 80), (2, 256, 160, 160),
                (2, 512, 80, 80))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cfg(size=SIZE):
    return PipelineConfig(detector=DetectorConfig(input_size=size), det_input_size=size)


def _pipeline(cuda, variant="yolov9e", dtype=torch.bfloat16):
    cfg = _cfg()
    return TwoStagePipeline.initialize(cfg, dtype=dtype, device=cuda,
                                       **detector_kwargs(variant, cfg, cuda))


@pytest.mark.gpu
def test_the_deployed_form_folds_48_repconvs_into_the_bias_mode(cuda):
    model = _pipeline(cuda).det_model
    assert not any(isinstance(m, yolov9.RepConv) for m in model.modules())
    bn = sum(isinstance(m, ConvBN) and m.bn is not None for m in model.modules())
    x = torch.rand((2, 3, SIZE, SIZE), device=cuda).bfloat16()
    reset_launch_counts()
    with torch.inference_mode():
        out = model(x)
        torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    assert counts["silu_bias_bf16"] == REPCONVS and counts["cbfuse"] == 5
    assert counts["adown"] == ADOWNS
    # every unfolded ConvBN has a SiLU: one BatchNorm-mode pass each, no plain SiLU
    assert counts["bn_silu_bf16"] == bn and counts["bn_bf16"] == 0 and counts["silu_bf16"] == 0
    assert out["cls"].dtype == torch.float32 and bool(torch.isfinite(out["reg"]).all())


@pytest.mark.gpu
def test_it_runs_channels_last(cuda):
    model = _pipeline(cuda).det_model
    assert all(p.is_contiguous(memory_format=torch.channels_last)
               for p in model.parameters() if p.dim() == 4)
    seen = []

    def hook(mod, args, out):
        seen.append((type(mod).__name__, out.is_contiguous(memory_format=torch.channels_last)))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (ConvBN, torch.nn.Conv2d))]
    fused = []
    cbfuse = yolov9.cbfuse

    def spy(sources, target):
        out = cbfuse(sources, target)
        fused.append(out.is_contiguous(memory_format=torch.channels_last))
        return out

    yolov9.cbfuse = spy
    try:
        with torch.inference_mode():
            model(torch.rand((2, 3, SIZE, SIZE), device=cuda).bfloat16())
    finally:
        yolov9.cbfuse = cbfuse
        for h in handles:
            h.remove()
    assert len(seen) > 250 and all(ok for _, ok in seen)
    assert fused == [True] * 5


@pytest.mark.gpu
def test_run_fused_launches_the_fold_and_the_fan_ins(cuda):
    pipe = _pipeline(cuda)
    frames = torch.randint(0, 256, (2, 300, 400, 3), dtype=torch.uint8, device=cuda)
    reset_launch_counts()
    out = pipe.run_fused(frames, 0.001)
    torch.cuda.synchronize()
    assert out["valid"].shape[0] == 2
    assert LAUNCHES["silu_bias_bf16"] == REPCONVS and LAUNCHES["cbfuse"] == 5
    assert LAUNCHES["adown"] == ADOWNS
    assert LAUNCHES["nms_suppress"] == 1 and LAUNCHES["roi_crop_dense"] == 1


@pytest.mark.gpu
def test_the_other_injected_detectors_run_as_given(cuda):
    cfg = _cfg(64)
    for variant in DETECTOR_VARIANTS:
        model = detector_kwargs(variant, cfg, cuda)["det_model"]
        assert (getattr(model, "deploy_form", None) is None) == (variant != "yolov9e")
        if variant == "yolov9e":
            continue
        pipe = TwoStagePipeline.initialize(cfg, dtype=torch.bfloat16, device=cuda,
                                           **detector_kwargs(variant, cfg, cuda))
        assert type(pipe.det_model) is type(model)
        assert pipe.det_model.state_dict().keys() == model.state_dict().keys()


def _bits(t):
    return t.contiguous().view(torch.int16)


def _front_equal(x):
    reset_launch_counts()
    x1, x2p = adown_front_cuda(x)
    want1, want2 = adown_front_plain(x)
    torch.cuda.synchronize()
    assert LAUNCHES["adown"] == 1
    for got, want in ((x1, want1), (x2p, want2)):
        assert got.shape == want.shape
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(_bits(got), _bits(want))
    return x1, x2p


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ADOWN_SHAPES + ((2, 64, 33, 35), (3, 16, 2, 2), (1, 32, 5, 2)))
def test_the_adown_front_is_atens_chain_bit_for_bit(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(26)
    x = (torch.randn(shape, generator=gen, device=cuda) * 4).bfloat16().contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        _front_equal(x)


@pytest.mark.gpu
def test_the_adown_front_keeps_atens_nans_infinities_and_zeros(cuda):
    gen = torch.Generator(device=cuda).manual_seed(27)
    x = torch.randn((2, 64, 33, 35), generator=gen, device=cuda).bfloat16()
    flat = x.view(-1)
    idx = torch.randint(0, flat.numel(), (600,), generator=gen, device=cuda)
    flat[idx] = torch.tensor([float("nan"), float("inf"), float("-inf")] * 200,
                             dtype=torch.bfloat16, device=cuda)
    x[:, :, :4, :4] = 0.0
    x[:, :, 1:3, 1:3] = -0.0
    x[1, :, 6:9, 6:9] = float("-inf")
    # bf16's least subnormal: averages that round to it, and to -0 beside +0
    x[1, :, 10:14, 10:14] = -(2.0 ** -133)
    x[1, :, 10:14:2, 10:14:2] = 0.0
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        x1, x2p = _front_equal(x)
    assert bool(x1.isnan().any()) and bool(x2p.isnan().any()) and bool(x2p.isinf().any())


@pytest.mark.gpu
def test_the_adown_front_raises_on_what_it_does_not_take(cuda):
    x = torch.randn((2, 64, 16, 16), device=cuda).bfloat16()
    assert takes_adown_kernel(x) and not takes_adown_kernel(x.float())
    with torch.enable_grad():
        assert not takes_adown_kernel(x.clone().requires_grad_())
    with pytest.raises(ValueError, match="channels-last"):
        adown_front_cuda(x)  # NCHW
    with pytest.raises(ValueError, match="multiple of 16"):
        adown_front_cuda(x[:, :24].contiguous(memory_format=torch.channels_last))
    with pytest.raises(ValueError, match="channels-last"):
        adown_front_cuda(x.float().contiguous(memory_format=torch.channels_last))


@pytest.mark.gpu
def test_run_fused_is_bit_equal_to_the_plain_adown_chain(cuda, monkeypatch):
    pipe = _pipeline(cuda)
    frames = torch.randint(0, 256, (2, 300, 400, 3), dtype=torch.uint8, device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(26))
    reset_launch_counts()
    got = pipe.run_fused(frames, 0.001)
    torch.cuda.synchronize()
    assert LAUNCHES["adown"] == ADOWNS
    monkeypatch.setattr(yolov9, "adown_front_cuda", adown_front_plain)
    reset_launch_counts()
    want = pipe.run_fused(frames, 0.001)
    torch.cuda.synchronize()
    assert LAUNCHES["adown"] == 0
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
