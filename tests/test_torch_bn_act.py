"""The act kernel's BatchNorm mode (``ops/act.py::batch_norm_act``,
``csrc/act.cu``'s ``litepi_bn_act_bf16``) and ``ConvBN``'s choice of it,
off the card.

An injected detector's ``ConvBN`` (a bias-free conv, eval BatchNorm with
float32 statistics, then the port's SiLU or nothing) on a bf16 CUDA tensor
without autograd hands the conv's output to the act kernel, which applies
the BatchNorm as ATen's CUDA kernel computes it and the SiLU after it in
one pass.  Here: the plain versions of that pass, the CPU dispatch, the
wrapper's checks that need no card, ``ConvBN``'s path choice and the
launches it makes per detector, and that every ``ConvBN`` on the CPU
computes what it did before.  The kernel itself is held against ATen's
two passes and the plain versions on the card
(``tests/test_torch_bn_act_cuda.py``, ``chip_smoke.py::check_act_bn``).
"""

import copy
from fractions import Fraction
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from litepi_tpu_torch.core.types import DetectorConfig
from litepi_tpu_torch.kernels import LAUNCHES
from litepi_tpu_torch.kernels.act import bn_act_bf16_cuda
from litepi_tpu_torch.models.layers import ConvBN, batch_norm_train
from litepi_tpu_torch.models.yolo import YoloLitePi
from litepi_tpu_torch.models.yolo12 import Yolo12L
from litepi_tpu_torch.models.yolov11 import YoloV11
from litepi_tpu_torch.ops import act

EPS = 1e-3


def _bn(c: int, seed: int) -> nn.BatchNorm2d:
    """An eval BatchNorm with seeded statistics and parameters, as a
    calibrated detector's."""
    gen = torch.Generator().manual_seed(seed)
    bn = nn.BatchNorm2d(c, eps=EPS).eval()
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(c, generator=gen) * 2)
        bn.running_var.copy_(torch.rand(c, generator=gen) * 4 + 0.05)
        bn.weight.copy_(torch.randn(c, generator=gen))
        bn.bias.copy_(torch.randn(c, generator=gen))
    return bn


def _state(bn: nn.BatchNorm2d):
    return bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps


def _x(c, hw, channels_last, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn((2, c, *hw), generator=gen) * 4).bfloat16()
    return x.contiguous(memory_format=torch.channels_last) if channels_last else x


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16)


def _bf16_neighbours(v: torch.Tensor):
    """``v`` (bf16) and the bf16 values one ulp below and above it."""
    bits = v.view(torch.int16).int()
    up = torch.where(v >= 0, bits + 1, bits - 1)
    down = torch.where(v > 0, bits - 1, torch.where(v == 0, (bits | 0x8000) + 1, bits + 1))
    as_bf16 = lambda b: b.to(torch.int16).view(torch.bfloat16)  # noqa: E731
    return v, as_bf16(down), as_bf16(up)


@pytest.mark.parametrize("with_silu", [True, False])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("c", [16, 307])
@pytest.mark.parametrize("hw", [(8, 10), (5, 7)])  # H*W % 8: 0 and 3
def test_plain_bn_act_is_its_float32_expression(with_silu, channels_last, c, hw):
    """The plain BatchNorm mode equals its float32 expression (``w * (x -
    m)`` in float32, times ``rsqrt(var + eps)`` plus ``s`` rounded once,
    taken here through float64, then bf16) followed by the plain SiLU or
    nothing; ``batch_norm_act`` on a CPU tensor is the plain version, keeps
    the layout and launches nothing."""
    bn = _bn(c, seed=c)
    x = _x(c, hw, channels_last, seed=1)
    m, var, w, s, eps = _state(bn)
    col = lambda t: t[:, None, None]  # noqa: E731
    inv = torch.rsqrt(var + eps)
    prod = col(w) * (x.float() - col(m))
    want = (prod.double() * col(inv).double() + col(s).double()).float().bfloat16()
    if with_silu:
        want = act.silu_bf16_plain(want)
    plain = (act.batch_norm_silu_bf16_plain if with_silu else act.batch_norm_bf16_plain)(
        x, m, var, w, s, eps)
    assert plain.dtype == torch.bfloat16
    assert torch.equal(_bits(plain), _bits(want))
    before = dict(LAUNCHES)
    got = act.batch_norm_act(x, m, var, w, s, eps, with_silu)
    assert LAUNCHES == before
    assert torch.equal(_bits(got), _bits(want))
    assert got.is_contiguous(memory_format=torch.channels_last if channels_last
                             else torch.contiguous_format)


@pytest.mark.parametrize("with_silu", [True, False])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("c", [16, 307])
@pytest.mark.parametrize("hw", [(8, 10), (5, 7)])
def test_plain_bn_act_within_one_ulp_of_torch_batch_norm(with_silu, channels_last, c, hw):
    """The CPU's own ``bn(x)`` (another order: a folded scale and shift)
    and the plain BatchNorm mode differ by at most one bf16 ulp; with SiLU
    the plain mode is the SiLU of ``bn(x)`` or of one of its bf16
    neighbours."""
    bn = _bn(c, seed=c + 1)
    x = _x(c, hw, channels_last, seed=2)
    with torch.no_grad():
        ref = bn(x.float()).bfloat16()
    plain_bn = act.batch_norm_bf16_plain(x, *_state(bn))
    got = (act.batch_norm_silu_bf16_plain(x, *_state(bn)) if with_silu else plain_bn)
    candidates = _bf16_neighbours(ref)
    if with_silu:
        candidates = [act.silu_bf16_plain(v) for v in candidates]
    hit = torch.zeros(x.shape, dtype=torch.bool)
    for v in candidates:
        hit |= _bits(got) == _bits(v)
    assert bool(hit.all()), int((~hit).sum())
    assert float((plain_bn.float() - ref.float()).abs().max()) > 0 or c == 16


def _exact_fma32(a: float, b: float, c: float) -> float:
    """a * b + c rounded once to float32 (ties to even), from the exact sum."""
    exact = Fraction(a) * Fraction(b) + Fraction(c)
    near = torch.tensor(float(exact), dtype=torch.float32)
    best = None
    for v in (torch.nextafter(near, torch.tensor(-float("inf"))), near,
              torch.nextafter(near, torch.tensor(float("inf")))):
        key = (abs(Fraction(float(v)) - exact), int(v.view(torch.int32)) & 1)
        if best is None or key < best[0]:
            best = (key, float(v))
    return best[1]


@pytest.mark.parametrize("cancel", [False, True])
def test_fma_f32_rounds_the_exact_sum_once(cancel):
    """``fma_f32`` is the exact ``a * b + c`` rounded once to float32, also
    where ``c`` nearly cancels the product (where two roundings differ
    most often)."""
    gen = torch.Generator().manual_seed(7 + cancel)
    n = 1500
    a, b, c = (torch.randn(n, generator=gen) * torch.exp(torch.randn(n, generator=gen) * 4)
               for _ in range(3))
    if cancel:
        c = (-(a.double() * b.double()) * (1 + torch.randn(n, generator=gen).double() * 1e-6)
             ).float()
    got = act.fma_f32(a, b, c)
    want = torch.tensor([_exact_fma32(float(a[i]), float(b[i]), float(c[i]))
                         for i in range(n)])
    assert torch.equal(got, want)
    assert not torch.equal(got, a * b + c)  # two roundings differ somewhere here


def _stand_in(dtype=torch.bfloat16, cuda=True, requires_grad=False, numel=2 * 16 * 64,
              dense=True):
    """What ``fuses_bn`` reads of a conv output, for a CUDA tensor without a
    card; its device is the one the module's buffers are on (the CPU)."""
    return SimpleNamespace(dtype=dtype, is_cuda=cuda, requires_grad=requires_grad,
                           device=torch.device("cpu"), numel=lambda: numel,
                           is_contiguous=lambda memory_format=None: dense)


def _eval(m: nn.Module) -> nn.Module:
    return m.eval()


def test_fuses_bn_only_for_eval_bn_bf16_cuda_without_autograd():
    """The BatchNorm goes to the act kernel only for an eval BatchNorm with
    float32 state on the output's device, the port's SiLU or no
    activation, a dense bf16 CUDA output below 2^31 - 1 values and no
    graph recorded; never on the CPU, in float32, in training, under
    autograd, for ReLU, ReLU6 or torch's SiLU, or for the deploy form."""
    silu = _eval(ConvBN(12, 16, 3))
    with torch.no_grad():
        assert silu.fuses_bn(_stand_in())
        assert _eval(ConvBN(12, 16, 1, act=None)).fuses_bn(_stand_in())
        assert _eval(ConvBN(16, 16, 7, groups=16, act=None)).fuses_bn(_stand_in())
        for a in ("relu", "relu6"):
            assert not _eval(ConvBN(12, 16, 3, act=a)).fuses_bn(_stand_in())
        torch_silu = _eval(ConvBN(12, 16, 3))
        torch_silu.act = F.silu  # one rounding (the anchor-free YOLOv5n's)
        assert not torch_silu.fuses_bn(_stand_in())
        assert not _eval(ConvBN(12, 16, 3, fused=True)).fuses_bn(_stand_in())
        assert not ConvBN(12, 16, 3).train().fuses_bn(_stand_in())
        assert not silu.fuses_bn(_stand_in(dtype=torch.float32))
        assert not silu.fuses_bn(_stand_in(dtype=torch.float16))
        assert not silu.fuses_bn(_stand_in(cuda=False))
        assert not silu.fuses_bn(torch.zeros(2, 16, 8, 8, dtype=torch.bfloat16))
        assert not silu.fuses_bn(_stand_in(dense=False))
        assert not silu.fuses_bn(_stand_in(numel=2**31 - 1))
        assert silu.fuses_bn(_stand_in(numel=2**31 - 2))
        assert not _eval(ConvBN(12, 2049, 1)).fuses_bn(_stand_in())
        assert _eval(ConvBN(12, 2048, 1)).fuses_bn(_stand_in())
        for dtype in (torch.float64, torch.bfloat16):
            assert not copy.deepcopy(silu).to(dtype).fuses_bn(_stand_in())
        stats_apart = copy.deepcopy(silu)
        stats_apart.bn.running_var = stats_apart.bn.running_var.double()
        assert not stats_apart.fuses_bn(_stand_in())
        untracked = _eval(ConvBN(12, 16, 3))
        untracked.bn.running_mean = untracked.bn.running_var = None
        assert not untracked.fuses_bn(_stand_in())
    # with grad enabled: the BatchNorm's parameters require grad
    assert not silu.fuses_bn(_stand_in())
    frozen = _eval(ConvBN(12, 16, 3)).requires_grad_(False)
    assert frozen.fuses_bn(_stand_in())
    assert not frozen.fuses_bn(_stand_in(requires_grad=True))
    with torch.inference_mode():
        assert silu.fuses_bn(_stand_in())


@pytest.mark.parametrize("x, match", [
    (torch.zeros(2, 16, 8, 8, dtype=torch.bfloat16), "4-D bf16 CUDA"),  # device
    (torch.zeros(2, 16, 8, 8), "4-D bf16 CUDA"),  # dtype
    (torch.zeros(16, 64, dtype=torch.bfloat16), "4-D bf16 CUDA"),  # shape
    (torch.zeros(2, 2049, 1, 1, dtype=torch.bfloat16), "more than 2048"),
])
def test_bn_wrapper_rejects_an_input_it_does_not_take(x, match):
    bn = _bn(x.shape[1] if x.dim() == 4 else 16, seed=3)
    with pytest.raises(ValueError, match=match):
        bn_act_bf16_cuda(x, *_state(bn), True)


@pytest.mark.parametrize("which", ["mean", "var", "weight", "bias"])
@pytest.mark.parametrize("bad", ["float64", "bf16", "short", "strided"])
def test_bn_wrapper_rejects_state_it_does_not_take(which, bad):
    """Each of the four per-channel tensors must be a contiguous float32
    (C,) tensor on ``x``'s device: checked before the device of ``x``."""
    x = torch.zeros(2, 16, 8, 8, dtype=torch.bfloat16)
    state = dict(zip(("mean", "var", "weight", "bias"), _state(_bn(16, seed=4))[:4]))
    t = state[which]
    state[which] = {"float64": t.double(), "bf16": t.bfloat16(), "short": t[:8],
                    "strided": torch.zeros(32)[::2]}[bad]
    with pytest.raises(ValueError, match=f"{which} must be a contiguous float32"):
        bn_act_bf16_cuda(x, *state.values(), EPS, False)


def test_batch_norm_act_takes_only_bf16():
    bn = _bn(16, seed=5)
    with pytest.raises(ValueError, match="must be bf16"):
        act.batch_norm_act(torch.zeros(2, 16, 4, 4), *_state(bn), True)


def _old_forward(m: ConvBN, x: torch.Tensor) -> torch.Tensor:
    """``ConvBN.forward`` before the BatchNorm mode."""
    y = m.conv(x)
    if m.bn is not None:
        y = batch_norm_train(m.bn, y) if m.training else m.bn(y)
    return m.act(y)


@pytest.mark.parametrize("a", ["silu", None, "relu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("grad", [False, True])
def test_convbn_with_batch_norm_on_the_cpu_computes_as_before(a, dtype, training, grad):
    """On a CPU tensor every ``ConvBN`` with BatchNorm (SiLU, none or ReLU;
    bf16 or float32; eval or train; with or without autograd) gives the
    bits and the running statistics it gave before the BatchNorm mode, and
    launches nothing."""
    torch.manual_seed(6)
    m = ConvBN(12, 16, 3, act=a).to(dtype)
    m.bn = _bn(16, seed=6).float()
    m.train(training)
    ref = copy.deepcopy(m)
    x = _x(12, (8, 8), False, seed=7).to(dtype)
    before = dict(LAUNCHES)
    with torch.set_grad_enabled(grad):
        got, want = m(x), _old_forward(ref, x)
    assert LAUNCHES == before
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(m.bn.running_mean, ref.bn.running_mean)
    assert torch.equal(m.bn.running_var, ref.bn.running_var)


def _bn_calls(model: nn.Module, x: torch.Tensor, **kw):
    """Each ``ConvBN`` call of ``model(x)`` as (engages the BatchNorm mode on
    a bf16 CUDA output without autograd, with SiLU)."""
    calls = []
    for m in model.modules():
        if isinstance(m, ConvBN):
            m.register_forward_hook(lambda m, inp, out: calls.append(
                (m.fuses_bn(_stand_in(numel=out.numel())), m.act is act.silu)))
    with torch.no_grad():
        model(x, **kw)
    return calls


@pytest.mark.parametrize("detector, size, silu, plain", [
    ("yolov11n", 64, 77, 4),
    ("yolo12l", 128, 141, 64),
    ("litepi", 64, 0, 0),
])
def test_launches_per_detector_forward(detector, size, silu, plain):
    """Per forward, YOLOv11n's 81 ``ConvBN`` calls take the BatchNorm mode,
    77 with SiLU and 4 without (C2PSA's qkv, pe, proj and second FFN conv);
    YOLO12-L's 205, 141 with SiLU and 64 without (each of its 16 ABlocks'
    qkv, pe, proj and second MLP conv); the deploy-form litepi detector's
    none (its BatchNorm is folded): the launch counts ``chip_smoke.py``
    holds per ``run_fused``."""
    if detector == "litepi":
        model = YoloLitePi(DetectorConfig(), fused=True).eval()
        c0 = model.backbone.stem.conv.out_channels
        calls = _bn_calls(model, torch.zeros(1, c0, size, size), from_stem=True)
    else:
        model = (YoloV11(num_classes=1) if detector == "yolov11n" else Yolo12L()).eval()
        calls = _bn_calls(model, torch.zeros(1, 3, size, size))
    fused = [with_silu for engages, with_silu in calls if engages]
    assert sum(fused) == silu and len(fused) - sum(fused) == plain
    assert len(calls) == len(fused) or detector == "litepi"
