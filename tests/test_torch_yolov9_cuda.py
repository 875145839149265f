"""YOLOv9-E on the card (``gpu``; skips without one): the pipeline's bf16
deployed form sends each of its 48 folded RepConvs through the act kernel's
bias mode and every other ConvBN through its BatchNorm mode, fuses 5 times
per forward, runs channels last from its weights to every conv's and
fan-in's output, and does so inside ``run_fused``; the other injected
detectors bring no deployed form and run as given.  Imports neither JAX nor
the test helpers, so that it runs on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_yolov9_cuda.py``."""

import pytest
import torch

from litepi_tpu_torch.core.types import DetectorConfig, PipelineConfig
from litepi_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from litepi_tpu_torch.models import yolov9
from litepi_tpu_torch.models.layers import ConvBN
from litepi_tpu_torch.models.registry import DETECTOR_VARIANTS, detector_kwargs
from litepi_tpu_torch.pipeline import TwoStagePipeline

SIZE = 256
REPCONVS = 48


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
