"""The default detector channels last on the card (``gpu``; skips without
one): a bf16 ``run_fused`` at the serving settings, B=8 640² frames, runs no
cuDNN layout pass under ``litepi.detect`` but around the convs of the C2f
blocks that run NCHW (``runs_nchw``), counts one channels-last body per
call, and the channels-last body's ``reg`` / ``cls`` agree with the same
weights and stem activations run NCHW within the gap between that NCHW
bf16 program and the same values in float32.  Imports neither JAX nor the
test helpers, so that it runs on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_channels_last_cuda.py``."""

import copy
import dataclasses

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from litepi_tpu_torch.core.types import NMSConfig, PipelineConfig
from litepi_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from litepi_tpu_torch.models.yolo import runs_nchw
from litepi_tpu_torch.pipeline import TwoStagePipeline
from litepi_tpu_torch.weights.graph_ops import tf32_allowed

B = 8
LAYOUT_PASSES = ("nchwToNhwc", "nhwcToNchw")
SERVING = PipelineConfig(nms=NMSConfig(max_candidates=64, max_detections=16),
                         input_color="bgr", crop_det_budget=8, cls_crop_budget=4 * B)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def serving(cuda):
    pipe = TwoStagePipeline.initialize(SERVING, seed=0, dtype=torch.bfloat16, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(19)
    frames = torch.randint(0, 256, (B, 640, 640, 3), generator=gen, device=cuda,
                           dtype=torch.uint8)
    pipe.run_fused(frames)  # warm-up: cuDNN's algorithm choices
    torch.cuda.synchronize()
    return pipe, frames


CONVS = ("aten::cudnn_convolution", "aten::_convolution", "aten::convolution", "aten::conv2d")


def _within(event, span: str) -> bool:
    while event is not None:
        if event.name == span:
            return True
        event = event.cpu_parent
    return False


def _conv_weight(event):
    """The weight shape of the conv op that launched ``event``'s kernels."""
    while event is not None and event.name not in CONVS:
        event = event.cpu_parent
    return None if event is None else tuple(event.input_shapes[1])


@pytest.mark.gpu
def test_run_fused_runs_no_layout_pass_under_detect(serving):
    pipe, frames = serving
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        pipe.run_fused(frames)
        torch.cuda.synchronize()
    pipe.run_fused(frames)
    torch.cuda.synchronize()
    assert LAUNCHES["det_channels_last"] == 2
    nchw_convs = {tuple(m.weight.shape) for blk in pipe.det_model.modules()
                  if runs_nchw(blk)
                  for m in blk.modules() if isinstance(m, torch.nn.Conv2d)}
    assert nchw_convs  # litepi's c2f1, 12 wide
    under_detect = [(k.name, e) for e in prof.events() if e.device_type == DeviceType.CPU
                    for k in e.kernels if _within(e, "litepi.detect")]
    # the detector's convs, SiLUs, pools, cats and adds: well over a hundred
    assert len(under_detect) > 100, [n for n, _ in under_detect]
    passes = [(n, _conv_weight(e)) for n, e in under_detect
              if any(p in n for p in LAYOUT_PASSES)]
    assert [(n, w) for n, w in passes if w not in nchw_convs] == []


@pytest.mark.gpu
def test_channels_last_body_matches_nchw(serving):
    pipe, frames = serving
    with torch.inference_mode():
        act = pipe._stem(frames)
        assert act.is_contiguous(memory_format=torch.channels_last)
        got = pipe._detect(act)
        nchw = copy.deepcopy(pipe.det_model).to(memory_format=torch.contiguous_format)
        assert nchw.backbone.down1.conv.weight.is_contiguous()
        want = nchw(act.contiguous(), from_stem=True)
        with tf32_allowed(False):
            ref = copy.deepcopy(nchw).float()(act.float().contiguous(), from_stem=True)
    for key in ("reg", "cls"):
        layout_gap = (got[key].float() - want[key].float()).abs().max().item()
        bf16_gap = (want[key].float() - ref[key]).abs().max().item()
        print(f"{key}: channels last vs NCHW {layout_gap}, NCHW bf16 vs float32 {bf16_gap}, "
              f"bit-equal {torch.equal(got[key], want[key])}")
        assert layout_gap <= bf16_gap


@pytest.mark.gpu
def test_letterboxed_frames_run_channels_last(cuda):
    """Frames of another size take the letterbox and the stem conv (NCHW:
    3 input channels); that branch hands the body channels last too."""
    pipe = TwoStagePipeline.initialize(dataclasses.replace(SERVING, cls_crop_budget=8),
                                       seed=0, dtype=torch.bfloat16, device=cuda)
    frames = torch.randint(0, 256, (2, 360, 480, 3), device=cuda, dtype=torch.uint8)
    reset_launch_counts()
    out = pipe.run_fused(frames)
    torch.cuda.synchronize()
    assert LAUNCHES["det_channels_last"] == 1 and LAUNCHES["stem"] == 0
    assert out["boxes"].shape == (2, 8, 4)
