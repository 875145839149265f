"""YOLOv9-E in the port (``litepi_tpu_torch/models/yolov9.py``) against the
benchmark's plain float32 reference (``cardbench/reference/yolov9.py``),
on the CPU, one torch thread; no JAX package has this model.

Weights are ``cardbench.weights.make_states``'s (``raw_state`` draws,
BatchNorm calibrated on seeded frames, both branches of every RepConv
apart, output layers scaled) for the ``yolov9e-shufflenetv2``
configuration at a 64x64 input: every width and depth as published, P1
32x32 down to P5 2x2.  Also: the RepConv fold against the two branches, the
stack-free CBFuse against Ultralytics' stack-then-sum, ADown on odd and
even sizes, its front end's plain chain against the arithmetic its card
kernel states, the published parameter and FLOP counts, the pipeline's
deploy-form seam, and ``run_fused`` with the ``yolov9e`` variant on
letterboxed frames against the reference pipeline.  On the card:
``tests/test_torch_yolov9_cuda.py``; the cell's readers and counts:
``cardbench/tests/test_cardbench_yolov9.py``.
"""

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from cardbench import judge, program, spec, traffic
from cardbench.reference import yolov9 as ref_v9
from cardbench.reference.two_stage import Reference, build_model
from cardbench.weights import make_states
from litepi_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from litepi_tpu_torch.kernels.adown import adown_front_plain, takes_adown_kernel
from litepi_tpu_torch.models import YoloV9E, detector_kwargs
from litepi_tpu_torch.models.layers import ConvBN
from litepi_tpu_torch.models.registry import DETECTOR_VARIANTS
from litepi_tpu_torch.models.yolov9 import ADown, RepConv, cbfuse
from litepi_tpu_torch.weights.fold_bn import fold_repconvs
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture, used by pytestmark)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CELL = "yolov9e.card-b32-2048"
SIZE = 64
REPCONVS = 48  # 12 RepNCSPELAN4 x 2 RepCSP x 2 RepBottleneck
# float32 sums in other orders (the port's convs channels last, the
# reference's NCHW; the folded RepConv's one 3x3 sum against two convs
# added) over the model's 250 convs: measured 1.4e-6 of the largest output
# at most; the bf16 reference moves them by 1.3e-2 of it
HEAD_RTOL = 2e-5


def small_config(dtype="float32"):
    cfg = spec.resolve(CELL).config
    return dict(cfg, detector=dict(cfg["detector"], input_size=SIZE),
                serving=dict(cfg["serving"], dtype=dtype))


@pytest.fixture(scope="module")
def states():
    return make_states(small_config(), 11, "cpu")


def _loaded(model, state):
    model.eval().load_state_dict(state)
    return model


@pytest.fixture(scope="module")
def reference_outputs(states):
    """(x, the float32 reference's outputs, the bf16 reference's (BatchNorm
    in float32)) on two seeded canvases."""
    det, _ = states
    x = torch.rand((2, 3, SIZE, SIZE), generator=torch.Generator().manual_seed(3))
    ref = _loaded(build_model(small_config()["detector"]), det)
    with torch.no_grad():
        want = ref(x)
        ref.bfloat16()
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.float()
        rounded = ref(x.bfloat16())
    return x, want, rounded


@pytest.mark.parametrize("form, layout", [
    ("trained", torch.contiguous_format), ("deployed", torch.contiguous_format),
    ("deployed", torch.channels_last)])
def test_yolov9e_matches_the_reference_in_float32(states, reference_outputs, form, layout):
    det, _ = states
    x, want, rounded = reference_outputs
    model = YoloV9E(num_classes=1)
    if form == "deployed":
        model, state = model.deploy_form(det)
        assert not any(isinstance(m, RepConv) for m in model.modules())
    else:
        state = det
    model = _loaded(model, state).to(memory_format=layout)
    reset_launch_counts()
    with torch.no_grad():
        got = model(x.contiguous(memory_format=layout))
    assert LAUNCHES["cbfuse"] == 5
    a = sum((SIZE // s) ** 2 for s in (8, 16, 32))
    assert got["reg"].shape == (2, a, 64) and got["cls"].shape == (2, a, 1)
    for k in ("reg", "cls"):
        assert got[k].dtype == torch.float32
        peak = float(want[k].abs().max())
        assert peak > 1.0  # logits of a few units: the calibrated head does work
        torch.testing.assert_close(got[k], want[k], atol=HEAD_RTOL * peak, rtol=0)
        # the tolerance refuses a bf16 rendering
        assert float((rounded[k].float() - want[k]).abs().max()) > 100 * HEAD_RTOL * peak


def _bn_state(bn, gen):
    c = bn.num_features
    bn.weight.copy_(0.5 + torch.rand(c, generator=gen))
    bn.bias.copy_(torch.randn(c, generator=gen))
    bn.running_mean.copy_(torch.randn(c, generator=gen))
    bn.running_var.copy_(0.5 + torch.rand(c, generator=gen))


def test_the_folded_repconv_is_the_two_branch_one():
    gen = torch.Generator().manual_seed(4)
    rep = RepConv(24, 40).eval()
    with torch.no_grad():
        for branch in (rep.conv1, rep.conv2):
            branch.conv.weight.copy_(torch.randn(branch.conv.weight.shape, generator=gen) * 0.2)
            _bn_state(branch.bn, gen)
    state = {f"cv1.{k}": v for k, v in rep.state_dict().items()}
    state["other.weight"] = torch.ones(3)
    folded = fold_repconvs(state, ["cv1"])
    assert set(folded) == {"cv1.conv.weight", "cv1.conv.bias", "other.weight"}
    assert folded["cv1.conv.weight"].shape == (40, 24, 3, 3)
    assert folded["cv1.conv.weight"].dtype == torch.float32
    conv = ConvBN(24, 40, 3, fused=True).eval()
    conv.load_state_dict({k[len("cv1."):]: v for k, v in folded.items() if k.startswith("cv1.")})
    x = torch.randn((2, 24, 9, 7), generator=gen)
    with torch.no_grad():
        want, got = rep(x), conv(x)
        # the 1x1 branch lands on the 3x3 kernel's centre: the centre alone
        # is conv2's folded 1x1 conv plus conv1's centre tap
        s2 = rep.conv2.bn.weight / torch.sqrt(rep.conv2.bn.running_var + 1e-3)
        centre = (rep.conv1.conv.weight[:, :, 1, 1]
                  * (rep.conv1.bn.weight / torch.sqrt(rep.conv1.bn.running_var + 1e-3))[:, None]
                  + rep.conv2.conv.weight[:, :, 0, 0] * s2[:, None])
    torch.testing.assert_close(folded["cv1.conv.weight"][:, :, 1, 1], centre, atol=1e-6, rtol=1e-6)
    peak = float(want.abs().max())
    torch.testing.assert_close(got, want, atol=2e-6 * peak, rtol=0)
    # the same conv with bf16-rounded weights parts from the branches by far more
    conv_bf16 = ConvBN(24, 40, 3, fused=True).eval()
    conv_bf16.load_state_dict({k[len("cv1."):]: v.bfloat16().float()
                               for k, v in folded.items() if k.startswith("cv1.")})
    with torch.no_grad():
        assert float((conv_bf16(x) - want).abs().max()) > 100 * 2e-6 * peak


def _ultralytics_cbfuse(sources, target):
    """``CBFuse.forward`` as Ultralytics writes it: every source resized
    by ``F.interpolate``, stacked with the target, the stack summed."""
    size = target.shape[2:]
    res = [F.interpolate(s, size=size, mode="nearest") for s in sources]
    return torch.sum(torch.stack(res + [target]), dim=0)


@pytest.mark.parametrize("layout", [torch.channels_last, torch.contiguous_format])
def test_the_stack_free_cbfuse_is_stack_then_sum(layout):
    gen = torch.Generator().manual_seed(5)
    # the first fan-in's shapes at a 64 input: P1 16x16 and the four below
    full = torch.randn((2, 32 + 64, 16, 16), generator=gen).contiguous(memory_format=layout)
    sources = [full[:, 32:]] + [torch.randn((2, 64, 16 // f, 16 // f), generator=gen)
                                for f in (2, 4, 8, 16)]
    target = torch.randn((2, 64, 16, 16), generator=gen).contiguous(memory_format=layout)
    reset_launch_counts()
    got = cbfuse(sources, target)
    assert LAUNCHES["cbfuse"] == 1
    assert got.is_contiguous(memory_format=layout) and got.data_ptr() != target.data_ptr()
    want = _ultralytics_cbfuse(sources, target)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    # in the reference's order (sources, then the target), bit for bit
    fuse = ref_v9.CBFuse([0] * 5)
    assert torch.equal(got, fuse([(s,) for s in sources] + [target]))
    with pytest.raises(ValueError, match="divide"):
        cbfuse([torch.zeros((1, 4, 3, 3))], torch.zeros((1, 4, 8, 8)))


@pytest.mark.parametrize("size", [(7, 7), (8, 8), (9, 10), (12, 5)])
def test_adown_on_odd_and_even_sizes(size):
    torch.manual_seed(6)
    port, ref = ADown(32, 48).eval(), ref_v9.ADown(32, 48).eval()
    ref.load_state_dict(port.state_dict())
    x = torch.randn((2, 32, *size))
    with torch.no_grad():
        got, want = port(x), ref(x)
    h, w = size
    # a 2x2 stride-1 pool, then 3x3/2 with padding 1: (H - 1 + 2 - 3) // 2 + 1
    assert got.shape == (2, 48, (h - 2) // 2 + 1, (w - 2) // 2 + 1)
    assert torch.equal(got, want)


def _front_by_hand(x):
    """(x1, x2p) by the arithmetic ``csrc/adown.cu`` states: per channel a
    float32 sum from 0 over the 2x2 window (rows outer), times 0.25, one
    rounding to x's dtype; the first half of those; and over the second
    half ATen's max-pool fold (start at -inf, take a value that is greater
    or NaN) over each 3x3/2 window clipped to the averaged map, row by
    row."""
    b, c, h, w = x.shape
    xf = x.float()
    s = torch.zeros((b, c, h - 1, w - 1))
    for di, dj in ((0, 0), (0, 1), (1, 0), (1, 1)):
        s = s + xf[:, :, di:di + h - 1, dj:dj + w - 1]
    avg = (s * 0.25).to(x.dtype)
    half = avg[:, c // 2:].float()
    ho, wo = (h - 2) // 2 + 1, (w - 2) // 2 + 1
    m = torch.full((b, c // 2, ho, wo), float("-inf"))
    for p in range(ho):
        for q in range(wo):
            for r in range(max(2 * p - 1, 0), min(2 * p + 2, h - 1)):
                for t in range(max(2 * q - 1, 0), min(2 * q + 2, w - 1)):
                    v, cur = half[:, :, r, t], m[:, :, p, q]
                    m[:, :, p, q] = torch.where((v > cur) | v.isnan(), v, cur)
    return avg[:, :c // 2], m.to(x.dtype)


def _same(got, want):
    """Equal bit for bit, but that a NaN may be any NaN (the CPU's
    conversions keep a NaN's sign and payload, the card's make it
    canonical)."""
    nan = got.isnan()
    bits = torch.int16 if got.element_size() == 2 else torch.int32
    return torch.equal(nan, want.isnan()) and torch.equal(
        got.masked_fill(nan, 0).contiguous().view(bits),
        want.masked_fill(nan, 0).contiguous().view(bits))


@pytest.mark.parametrize("layout", [torch.contiguous_format, torch.channels_last])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("size", [(2, 2), (7, 7), (8, 8), (33, 35), (12, 5)])
def test_adown_front_plain_is_the_kernels_arithmetic(size, dtype, layout):
    gen = torch.Generator().manual_seed(26)
    x = (torch.randn((2, 32, *size), generator=gen) * 3).to(dtype)
    flat = x.view(-1)
    # NaN and both infinities planted, one each in either half, and a
    # window of zeros of both signs
    flat[torch.randint(0, flat.numel(), (12,), generator=gen)] = torch.tensor(
        [float("nan"), float("inf"), float("-inf")] * 4, dtype=dtype)
    x[0, :, :2, :2] = torch.tensor([[0.0, -0.0], [-0.0, -0.0]], dtype=dtype)
    x = x.contiguous(memory_format=layout)
    x1, x2p = adown_front_plain(x)
    want1, want2 = _front_by_hand(x)
    h, w = size
    assert x1.shape == (2, 16, h - 1, w - 1)
    assert x2p.shape == (2, 16, (h - 2) // 2 + 1, (w - 2) // 2 + 1)
    assert bool(x1.isnan().any()) and bool(x2p.isnan().any() or x2p.isinf().any())
    assert _same(x1, want1) and _same(x2p, want2)
    # the old chain inside ADown: the pool, its halves, the max pool
    pooled = F.avg_pool2d(x, 2, 1, 0, False, True)
    assert _same(x1, pooled[:, :16]) and _same(x2p, F.max_pool2d(pooled[:, 16:], 3, 2, 1))


def test_the_adown_kernel_is_not_taken_off_the_card():
    x = torch.randn((1, 32, 8, 8))
    reset_launch_counts()
    for t in (x.bfloat16(), x, x.bfloat16().requires_grad_()):
        assert not takes_adown_kernel(t)
        ADown(32, 32).to(t.dtype)(t)
    assert LAUNCHES["adown"] == 0


def _flops(model, size):
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.zeros((1, 3, size, size), device="meta"))
    return counter.get_total_flops()


def _params(model):
    return sum(p.numel() for p in model.parameters())


def test_the_published_parameter_and_flop_counts():
    with torch.device("meta"):
        port, ref = YoloV9E(num_classes=80), ref_v9.YoloV9E(80, 16)
        deployed = YoloV9E(num_classes=80, deploy=True)
        wide = YoloV9E(num_classes=1)
    assert {k: v.shape for k, v in port.state_dict().items()} == {
        k: v.shape for k, v in ref.state_dict().items()}
    assert sum(isinstance(m, RepConv) for m in port.modules()) == REPCONVS
    # Ultralytics' yolov9e.yaml: 58.1 M trained and 57.3-57.4 M
    # re-parameterised (WongKinYiu's converted model: every BatchNorm folded
    # too, a folded one leaving a bias of its width)
    assert _params(port) == 58_206_576
    bn = sum(m.num_features for m in deployed.modules() if isinstance(m, torch.nn.BatchNorm2d))
    assert _params(deployed) - bn == 57_438_064
    # at 640 and 80 classes 192.5 GFLOPs published as trained (189.0
    # re-parameterised: the deployed form counts 189.46); at the cell's 1280
    # and one class 765 GFLOP a frame as trained
    assert _flops(port, 640) / 1e9 == pytest.approx(191.66, abs=0.01)
    assert _flops(wide, 1280) / 1e9 == pytest.approx(765.29, abs=0.01)


def test_only_yolov9e_brings_a_deployed_form():
    cfg = program.pipeline_config(small_config(), 2)
    for variant in DETECTOR_VARIANTS:
        with torch.device("meta"):
            model = detector_kwargs(variant, cfg, "cpu")["det_model"]
        assert (getattr(model, "deploy_form", None) is None) == (variant != "yolov9e")


def test_run_fused_with_yolov9e_runs_the_deployed_form_as_the_reference_pipeline(states):
    det, cls = states
    cfg = small_config()
    frames = traffic.make_frames(11, 0, 2, 100, 90, "cpu")
    run_fused = program.build(cfg, det, cls, 2, "cpu")
    model = run_fused.__self__.det_model
    assert not any(isinstance(m, RepConv) for m in model.modules())
    assert sum(isinstance(m, ConvBN) and m.bn is None for m in model.modules()) == REPCONVS
    assert not any(".conv1." in k or ".conv2." in k for k in model.state_dict())
    assert sum(k.endswith(".running_var") for k in model.state_dict()) == sum(
        k.endswith(".running_var") for k in det) - 2 * REPCONVS
    reset_launch_counts()
    got = run_fused(frames)
    assert LAUNCHES["cbfuse"] == 5 and LAUNCHES["silu_bias_bf16"] == 0 and LAUNCHES["adown"] == 0
    ref = Reference(cfg, det, cls, "cpu")
    want = ref.run_pipeline(frames)
    v = want["valid"]
    assert torch.equal(got["valid"], v) and bool(v.any())
    assert torch.allclose(got["boxes"][v], want["boxes"][v], atol=1e-3)
    assert torch.allclose(got["det_scores"], want["det_scores"], atol=1e-5)
    assert torch.allclose(got["cls_probs"][v], want["cls_probs"][v], atol=1e-5)
    assert torch.equal(got["cls_labels"][v], want["cls_labels"][v])
    numbers = judge.gaps(ref, [(frames, got)])
    assert numbers["box"] < 1e-3 and numbers["score"] < 1e-4 and numbers["choice"] < 1e-3

