"""The detectors channels last on the card (``gpu``; skips without one): a
bf16 ``run_fused`` at the serving settings, B=8 640² frames, runs no cuDNN
layout pass under ``litepi.detect`` but around the convs of the C2f blocks
that run NCHW (``runs_nchw``); every conv weight of the pipeline's
detector, default or injected, is placed channels last but those blocks';
the channels-last litepi body's ``reg`` / ``cls`` agree with the same
weights and stem activations run NCHW within the gap between that NCHW
bf16 program and the same values in float32; and an injected YOLOv11n's
``run_fused`` is bit-equal with its weights placed channels last or left
NCHW.  Imports neither JAX nor the test helpers, so that it runs on the
card with
``python -m pytest --noconftest -m gpu tests/test_torch_channels_last_cuda.py``."""

import copy
import dataclasses

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from litepi_tpu_torch.core.types import NMSConfig, PipelineConfig
from litepi_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from litepi_tpu_torch.models import detector_kwargs
from litepi_tpu_torch.models.layers import runs_nchw
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


def _misplaced(model):
    """The convs of ``model`` whose weight is not in the layout its block
    runs in: NCHW inside the blocks that run NCHW, channels last elsewhere."""
    nchw = {m for blk in model.modules() if runs_nchw(blk) for m in blk.modules()}
    return [name for name, m in model.named_modules() if isinstance(m, torch.nn.Conv2d)
            and not m.weight.is_contiguous(
                memory_format=torch.contiguous_format if m in nchw else torch.channels_last)]


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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        pipe.run_fused(frames)
        torch.cuda.synchronize()
    assert _misplaced(pipe.det_model) == []
    assert pipe._raw_stem.conv.weight.is_contiguous()  # the letterboxed stem: NCHW
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
    body_in = []
    pipe.det_model.backbone.down1.register_forward_pre_hook(
        lambda mod, args: body_in.append(args[0].is_contiguous(memory_format=torch.channels_last)))
    reset_launch_counts()
    out = pipe.run_fused(frames)
    torch.cuda.synchronize()
    assert body_in == [True] and LAUNCHES["stem"] == 0
    assert out["boxes"].shape == (2, 8, 4)


@pytest.mark.gpu
def test_injected_detector_weights_layout_keeps_the_bits(cuda):
    """An injected YOLOv11n is placed channels last like the default
    detector, and its bf16 ``run_fused`` on 640² frames is bit-equal to the
    same pipeline with the detector's weights left NCHW (cuDNN then copies
    each kxk weight to channels last on every call)."""
    cfg = dataclasses.replace(SERVING, classifier_arch="resnet18")
    pipe = TwoStagePipeline.initialize(cfg, seed=0, dtype=torch.bfloat16, device=cuda,
                                       **detector_kwargs("yolov11n", cfg, cuda))
    assert _misplaced(pipe.det_model) == []
    nchw = copy.copy(pipe)
    nchw.det_model = copy.deepcopy(pipe.det_model).to(memory_format=torch.contiguous_format)
    assert nchw.det_model.down1.conv.weight.is_contiguous()
    gen = torch.Generator(device=cuda).manual_seed(20)
    frames = torch.randint(0, 256, (B, 640, 640, 3), generator=gen, device=cuda,
                           dtype=torch.uint8)
    outs = [p.run_fused(frames) for p in (pipe, nchw, pipe)]
    for key in outs[0]:
        assert torch.equal(outs[0][key], outs[1][key]), key
        assert torch.equal(outs[0][key], outs[2][key]), key
