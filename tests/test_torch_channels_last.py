"""The detectors channels last, off the card.

On the card ``TwoStagePipeline`` places its detector, default or
injected, channels last (``models/layers.py::to_channels_last``) and hands
it a dense channels-last input, so that cuDNN's NHWC convs need no layout
pass around them; a C2f block narrower than cuDNN's fast NHWC kernels runs
NCHW inside it (``runs_nchw``); on the CPU the pipeline keeps NCHW.  Here:
the fused litepi detector and YOLOv11n give the same ``reg`` and ``cls``
in both layouts, anchors in the head's row-major (y, x) order; every conv
of the channels-last litepi body writes channels last but those of the
NCHW blocks (no other op turns the layout back); and a CPU pipeline, with
either detector, keeps NCHW weights and no hooks.
The card's side: ``tests/test_torch_channels_last_cuda.py``.
"""

import copy

import pytest
import torch
from torch import nn

from litepi_tpu_torch.core.types import DetectorConfig, NMSConfig, PipelineConfig
from litepi_tpu_torch.models import detector_kwargs
from litepi_tpu_torch.models.layers import runs_nchw, to_channels_last
from litepi_tpu_torch.models.yolo import YoloLitePi
from litepi_tpu_torch.models.yolov11 import YoloV11
from litepi_tpu_torch.pipeline import TwoStagePipeline
from litepi_tpu_torch.weights.fold_bn import BN_EPS, fold_pipeline_state
from litepi_tpu_torch.weights.seeded import seeded_state
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CL = torch.channels_last


def _fused_detector(size: int) -> YoloLitePi:
    """The deploy-form litepi detector (yolo_plus_v2 widths) at ``size``,
    float32, seeded weights with BatchNorm folded."""
    cfg = DetectorConfig(input_size=size)
    model = YoloLitePi(cfg, fused=True).eval()
    model.load_state_dict(fold_pipeline_state(seeded_state(YoloLitePi(cfg), 0), BN_EPS))
    return model


def _yolov11n() -> YoloV11:
    """YOLOv11n, float32, seeded weights, BatchNorm kept (as injected)."""
    model = YoloV11().eval()
    model.load_state_dict(seeded_state(YoloV11(), 0))
    return model


@pytest.mark.parametrize("detector,from_stem", [
    ("litepi", False), ("litepi", True), ("yolov11n", False),
])
def test_channels_last_detector_equals_nchw(detector, from_stem):
    """Weights and input channels last give NCHW's ``reg`` and ``cls`` within
    1e-5 of their scale, in the same anchor order; each level's anchors are
    its head conv's outputs flattened row-major (y, x), which the head's
    flatten of an NHWC tensor must keep (an NCHW-order flatten of that
    memory would reorder them silently)."""
    nchw = _fused_detector(128) if detector == "litepi" else _yolov11n()
    cl = to_channels_last(copy.deepcopy(nchw))
    head = cl.head if detector == "litepi" else cl
    assert head.reg0_cv1.conv.weight.is_contiguous(memory_format=CL)  # a 3x3 conv
    gen = torch.Generator().manual_seed(3)
    x = torch.rand((2, 3, 128, 128), generator=gen)
    if from_stem:  # the pipeline's entry: the stem activation, computed apart
        with torch.no_grad():
            x = nchw.backbone.stem(x)
    args = (from_stem,) if detector == "litepi" else ()
    level_out = {}
    for name in ("reg0_out", "cls0_out", "reg2_out", "cls2_out"):
        getattr(head, name).register_forward_hook(
            lambda mod, inp, out, name=name: level_out.__setitem__(name, out))
    with torch.no_grad():
        want = nchw(x, *args)
        got = cl(x.contiguous(memory_format=CL), *args)
    for key in ("reg", "cls"):
        assert got[key].shape == want[key].shape
        scale = want[key].abs().max()
        assert (got[key] - want[key]).abs().max() <= 1e-5 * scale
    p3, p5 = 16 * 16, 4 * 4  # anchors of P3 (stride 8) and P5 (stride 32) at 128
    for key, level, first in (("reg", 0, 0), ("cls", 0, 0), ("reg", 2, -p5), ("cls", 2, -p5)):
        out = level_out[f"{key}{level}_out"]
        assert out.is_contiguous(memory_format=CL)
        rows = got[key][:, first:first + p3] if level == 0 else got[key][:, first:]
        # flatten(2) is row-major over (H, W) whatever the memory order
        assert torch.equal(rows, out.flatten(2).transpose(1, 2))


def test_channels_last_body_keeps_its_layout():
    """Every conv of the channels-last detector writes a dense channels-last
    output, but those of the one C2f block whose half width is not a
    multiple of 8 (litepi's ``c2f1``, 12 wide), which runs NCHW on NCHW
    weights: the other C2f blocks' chunked halves and concatenations,
    SPPF's pools, the neck's upsamples and concatenations hand the next
    conv channels last, so on the card cuDNN converts nothing between
    them."""
    model = to_channels_last(_fused_detector(128))
    nchw_blocks = [n for n, m in model.named_modules() if runs_nchw(m)]
    assert nchw_blocks == ["backbone.c2f1"] and model.backbone.c2f1.hidden == 12
    layouts = {}
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Conv2d):
            nchw = name.startswith("backbone.c2f1.")
            assert mod.weight.is_contiguous(memory_format=torch.contiguous_format if nchw else CL)
            mod.register_forward_hook(
                lambda m, inp, out, name=name, nchw=nchw: layouts.__setitem__(
                    name, out.is_contiguous(memory_format=torch.contiguous_format if nchw
                                            else CL)))
    x = torch.rand((2, 3, 128, 128), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        model(x.contiguous(memory_format=CL))
    assert len(layouts) == sum(isinstance(m, nn.Conv2d) for m in model.modules())
    assert [name for name, kept in layouts.items() if not kept] == []


def test_cpu_pipeline_keeps_nchw():
    """On the CPU the default detector stays NCHW on both stem branches
    (the stem kernel's plain version on canvas-sized frames, the letterbox
    and stem conv on others), and neither it nor an injected YOLOv11n is
    placed channels last: every kxk conv weight NCHW, no block re-laid out
    by a hook."""
    cfg = PipelineConfig(
        detector=DetectorConfig(name="tiny", base_channels=(32, 64, 128, 256, 512),
                                input_size=160),
        nms=NMSConfig(max_candidates=32, max_detections=8, min_area=4.0),
        num_classifier_classes=10, det_input_size=160)
    pipe = TwoStagePipeline.initialize(cfg, device="cpu")
    injected = TwoStagePipeline.initialize(cfg, device="cpu",
                                           **detector_kwargs("yolov11n", cfg, "cpu"))
    for model in (pipe.det_model, injected.det_model):
        convs = [m for m in model.modules() if isinstance(m, nn.Conv2d) and m.kernel_size != (1, 1)]
        assert convs and all(m.weight.is_contiguous() for m in convs)
        assert not any(m._forward_pre_hooks for m in model.modules())
    gen = torch.Generator().manual_seed(5)
    for hw in ((160, 160), (200, 300)):
        frames = torch.randint(0, 256, (2, *hw, 3), generator=gen, dtype=torch.uint8)
        with torch.inference_mode():
            act = pipe._stem(frames)
            assert act.is_contiguous() and act.shape == (2, 8, 80, 80)
            pipe._detect(act)
