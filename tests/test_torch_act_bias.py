"""The bf16 SiLU's bias mode (``ops/act.py::silu`` with a bias,
``csrc/act.cu``'s ``litepi_silu_bias_bf16``) and ``ConvBN``'s choice of it,
off the card.

A deploy-form ``ConvBN`` (a biased conv, then SiLU) on a bf16 CUDA tensor
without autograd runs its conv without the bias and hands the bias to the
SiLU kernel, which rounds the add as ATen's bf16 add and then each SiLU
step.  Here: the plain version of that pass, the CPU dispatch, the
wrapper's checks that need no card, ``ConvBN``'s path choice, and that
every other ``ConvBN`` computes what it did before.  The kernel itself is
held against the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py::check_act``).
"""

from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from litepi_tpu_torch.core.types import DetectorConfig
from litepi_tpu_torch.kernels import LAUNCHES
from litepi_tpu_torch.kernels.act import act_bias_bf16_cuda
from litepi_tpu_torch.models.layers import ConvBN, conv_bias_apart
from litepi_tpu_torch.models.yolo import YoloLitePi
from litepi_tpu_torch.ops import act


def _inputs(c, hw, channels_last, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn((2, c, *hw), generator=gen) * 4).bfloat16()
    bias = (torch.randn(c, generator=gen) * 2).bfloat16()
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    return x, bias


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("c", [12, 24])
@pytest.mark.parametrize("hw", [(8, 10), (5, 7)])  # H*W % 8: 0 and 3
def test_plain_bias_silu_is_silu_of_the_bf16_bias_add(channels_last, c, hw):
    """The plain bias mode equals ``silu_bf16_plain`` of torch's bf16 add of
    the broadcast bias on every element, in both dense layouts; ``silu(x,
    bias)`` on a CPU tensor is the plain version, keeps the layout and
    launches nothing."""
    x, bias = _inputs(c, hw, channels_last)
    want = act.silu_bf16_plain(x + bias[:, None, None])
    plain = act.silu_bias_bf16_plain(x, bias)
    assert plain.dtype == torch.bfloat16
    assert torch.equal(plain.view(torch.int16), want.view(torch.int16))
    before = dict(LAUNCHES)
    got = act.silu(x, bias)
    assert LAUNCHES == before
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert got.is_contiguous(memory_format=torch.channels_last if channels_last
                             else torch.contiguous_format)


def test_bias_silu_outside_the_kernel_adds_then_activates():
    """float32 and autograd take the add, then ``silu``: float32 torch's
    ops, bf16 with a gradient the rounded VJP of both."""
    x, bias = _inputs(12, (4, 4), False, seed=1)
    xf, bf = x.float(), bias.float()
    assert torch.equal(act.silu(xf, bf), F.silu(xf + bf[:, None, None]))
    xg = x.clone().requires_grad_(True)
    y = act.silu(xg, bias)
    assert torch.equal(y.detach(), act.silu_bias_bf16_plain(x, bias))
    y.sum().backward()
    assert xg.grad is not None and xg.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("x, bias, match", [
    (torch.zeros(2, 12, 8, 8, dtype=torch.bfloat16), torch.zeros(12, dtype=torch.bfloat16),
     "4-D bf16 CUDA"),
    (torch.zeros(2, 12, 8, 8), torch.zeros(12), "4-D bf16 CUDA"),
    (torch.zeros(12, 64, dtype=torch.bfloat16), torch.zeros(12, dtype=torch.bfloat16),
     "4-D bf16 CUDA"),
])
def test_bias_wrapper_rejects_what_the_kernel_does_not_take(x, bias, match):
    with pytest.raises(ValueError, match=match):
        act_bias_bf16_cuda(x, bias)


def _old_forward(m: ConvBN, x: torch.Tensor) -> torch.Tensor:
    """``ConvBN.forward`` before the bias mode."""
    y = conv_bias_apart(m.conv, x) if m.bias_apart else m.conv(x)
    if m.bn is not None:
        y = m.bn(y)
    return m.act(y)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("bias_apart", [False, True])
@pytest.mark.parametrize("grad", [False, True])
def test_convbn_on_the_cpu_computes_as_before(dtype, fused, bias_apart, grad):
    """On a CPU tensor every ``ConvBN`` (deploy form or with BatchNorm,
    bias apart or not, bf16 or float32, with or without autograd) gives the
    bits it gave before the bias mode, and launches nothing."""
    torch.manual_seed(3)
    m = ConvBN(12, 24, 3, fused=fused, bias_apart=bias_apart).eval().to(dtype)
    x, _ = _inputs(12, (8, 8), False, seed=4)
    x = x.to(dtype)
    before = dict(LAUNCHES)
    with torch.set_grad_enabled(grad):
        got, want = m(x), _old_forward(m, x)
    assert LAUNCHES == before
    assert got.dtype == dtype and torch.equal(got, want)


def _standin(dtype=torch.bfloat16, cuda=True, requires_grad=False):
    """What ``folds_bias`` reads of an input, for a CUDA tensor without a card."""
    return SimpleNamespace(dtype=dtype, is_cuda=cuda, requires_grad=requires_grad)


def test_folds_bias_only_for_bias_silu_bf16_cuda_without_autograd():
    """The bias goes to the SiLU kernel only for a biased conv without
    BatchNorm, the port's SiLU, a bf16 CUDA input and no graph recorded; a
    grouped conv only with its bias apart."""
    deploy = ConvBN(12, 24, 3, fused=True)
    with torch.no_grad():
        assert deploy.folds_bias(_standin())
        assert ConvBN(12, 24, 3, fused=True, bias_apart=True).folds_bias(_standin())
        assert ConvBN(24, 24, 3, groups=24, fused=True, bias_apart=True).folds_bias(_standin())
        assert not ConvBN(24, 24, 3, groups=24, fused=True).folds_bias(_standin())
        assert not ConvBN(12, 24, 3, fused=False).folds_bias(_standin())  # BatchNorm, no bias
        for a in ("relu", "relu6", None):
            assert not ConvBN(12, 24, 3, act=a, fused=True).folds_bias(_standin())
        torch_silu = ConvBN(12, 24, 3, fused=True)
        torch_silu.act = F.silu  # one rounding (the anchor-free YOLOv5n's)
        assert not torch_silu.folds_bias(_standin())
        assert not deploy.folds_bias(_standin(dtype=torch.float32))
        assert not deploy.folds_bias(_standin(dtype=torch.float16))
        assert not deploy.folds_bias(_standin(cuda=False))
        assert not deploy.folds_bias(torch.zeros(1, 12, 8, 8, dtype=torch.bfloat16))
    # with grad enabled: the parameters require grad, so a graph is recorded
    assert not deploy.folds_bias(_standin())
    frozen = ConvBN(12, 24, 3, fused=True).requires_grad_(False)
    assert frozen.folds_bias(_standin())
    assert not frozen.folds_bias(_standin(requires_grad=True))
    with torch.inference_mode():
        assert deploy.folds_bias(_standin())


def test_litepi_detector_folds_every_conv_after_the_stem():
    """The deploy-form litepi detector run from the stem's output has 56
    ``ConvBN`` calls, each a biased conv with the port's SiLU: on a bf16
    CUDA input without autograd all 56 fold their bias (the launch count
    ``chip_smoke.py`` holds per ``run_fused``); at 640 each plane's H * W
    is a multiple of 8 (the kernel's vector path)."""
    model = YoloLitePi(DetectorConfig(), fused=True).eval()
    calls = []
    for m in model.modules():
        if isinstance(m, ConvBN):
            m.register_forward_hook(
                lambda m, inp, out: calls.append((m.folds_bias(_standin()), out.shape[2:])))
    c0 = model.backbone.stem.conv.out_channels
    with torch.no_grad():
        model(torch.zeros(1, c0, 64, 64), from_stem=True)
    assert len(calls) == 56 and all(folds for folds, _ in calls)
    # at 640 the stem's output is 320x320: each plane 5x as high and wide
    assert all((5 * h) * (5 * w) % 8 == 0 for _, (h, w) in calls)
