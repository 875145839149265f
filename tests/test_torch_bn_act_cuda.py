"""The act kernel's BatchNorm mode on the card (``gpu``; skips without one):
bit-equal to ATen's eval BatchNorm followed by the port's SiLU kernel (or
nothing) and to the plain versions, for every ``ConvBN`` call of YOLOv11n
at 640 and YOLO12-L at 1280 in the layout it receives inside ``run_fused``
(and for the same values at an unaligned address), at the kernel's edges
(scalar tail, NCHW planes of H * W % 8 != 0, 307 and 2,048 channels); and
each detector's ``run_fused`` bit-equal with the mode turned off.
Imports neither JAX nor the test helpers, so that it runs on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_bn_act_cuda.py``."""

import dataclasses

import pytest
import torch
from torch import nn

from litepi_tpu_torch.core.types import NMSConfig, PipelineConfig
from litepi_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from litepi_tpu_torch.kernels.act import bn_act_bf16_cuda
from litepi_tpu_torch.models import detector_kwargs
from litepi_tpu_torch.models.layers import ConvBN
from litepi_tpu_torch.ops import act
from litepi_tpu_torch.pipeline import TwoStagePipeline

B = 2
SERVING = PipelineConfig(nms=NMSConfig(max_candidates=64, max_detections=16),
                         input_color="bgr", crop_det_budget=8, cls_crop_budget=4 * B,
                         classifier_arch="resnet18")
# per run_fused: (BatchNorm + SiLU, BatchNorm alone) ConvBN calls
CALLS = {"yolov11n": (77, 4), "yolo12l": (141, 64)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randomise_batch_norms(model: nn.Module, seed: int) -> None:
    """Seeded running statistics and parameters in every BatchNorm, in
    place (float32, on the card), as a calibrated detector's."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                c = m.num_features
                for t, v in ((m.running_mean, torch.randn(c, generator=gen) * 0.5),
                             (m.running_var, torch.rand(c, generator=gen) * 2 + 0.05),
                             (m.weight, torch.randn(c, generator=gen) * 0.5 + 1),
                             (m.bias, torch.randn(c, generator=gen) * 0.5)):
                    t.copy_(v)


def _pipeline(variant: str, dev):
    size = 1280 if variant == "yolo12l" else 640
    cfg = dataclasses.replace(SERVING, det_input_size=size,
                              detector=dataclasses.replace(SERVING.detector, input_size=size))
    pipe = TwoStagePipeline.initialize(cfg, seed=0, dtype=torch.bfloat16, device=dev,
                                       **detector_kwargs(variant, cfg, dev))
    _randomise_batch_norms(pipe.det_model, seed=len(variant))
    gen = torch.Generator(device=dev).manual_seed(size)
    frames = torch.randint(0, 256, (B, size, size, 3), generator=gen, device=dev,
                           dtype=torch.uint8)
    return pipe, frames


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16)


def _unaligned(y: torch.Tensor) -> torch.Tensor:
    """``y``'s values in its layout, at an address 2 bytes past a 16-byte
    boundary (the kernel's scalar path for the whole tensor)."""
    buf = torch.empty(y.numel() + 1, dtype=y.dtype, device=y.device)
    out = buf[1:].as_strided(y.shape, y.stride())
    out.copy_(y)
    return out


def _check(m: ConvBN, y: torch.Tensor) -> list:
    """The BatchNorm mode on ``y`` (the conv's output) against ATen's
    BatchNorm then the act, and against the plain version; the same on an
    unaligned copy.  Returns what differs."""
    bn, with_silu = m.bn, m.act is act.silu
    state = (bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)
    want = m.act(bn(y))
    plain = (act.batch_norm_silu_bf16_plain if with_silu else act.batch_norm_bf16_plain)(
        y, *state)
    bad = []
    for where, x in (("aligned", y), ("unaligned", _unaligned(y))):
        got = bn_act_bf16_cuda(x, *state, with_silu)
        if got.stride() != y.stride():
            bad.append((where, "strides", got.stride(), y.stride()))
        for name, ref in (("ATen + act", want), ("plain", plain)):
            n = int((_bits(got) != _bits(ref)).sum())
            if n:
                bad.append((where, name, tuple(y.shape), y.stride(), n))
    return bad


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["yolov11n", "yolo12l"])
def test_every_convbn_of_run_fused_bit_equal_to_atens_two_passes(cuda, variant):
    pipe, frames = _pipeline(variant, cuda)
    seen, bad = [], []

    def hook(conv, args, y):
        m = owner[conv]
        if m.fuses_bn(y):
            seen.append((m.act is act.silu, y.is_contiguous(memory_format=torch.channels_last),
                         y.numel() % 8))
            bad.extend(_check(m, y))

    owner = {m.conv: m for m in pipe.det_model.modules() if isinstance(m, ConvBN)}
    handles = [conv.register_forward_hook(hook) for conv in owner]
    try:
        pipe.run_fused(frames)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    with_silu = sum(s for s, _, _ in seen)
    assert (with_silu, len(seen) - with_silu) == CALLS[variant]
    assert bad == []
    print(f"{variant}: {len(seen)} ConvBN calls, channels last {sum(c for _, c, _ in seen)}, "
          f"with a scalar tail {sum(1 for *_, t in seen if t)}")


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["yolov11n", "yolo12l"])
def test_run_fused_bit_equal_with_the_mode_off(cuda, variant, monkeypatch):
    """``run_fused`` and the detector's raw outputs are bit-equal with the
    BatchNorm mode and with ATen's BatchNorm and the SiLU kernel (the
    predicate patched off); on, it launches the mode once per ``ConvBN``
    call and the plain SiLU mode never, off never the mode."""
    pipe, frames = _pipeline(variant, cuda)
    pipe.run_fused(frames)  # warm-up: cuDNN's algorithm choices
    silu, alone = CALLS[variant]
    raw = []
    pipe.det_model.register_forward_hook(
        lambda mod, args, out: raw.append({f"raw_{k}": v.clone() for k, v in out.items()}))
    outs, counts = [], []
    for off in (False, True, False):
        with monkeypatch.context() as mp:
            if off:
                mp.setattr(ConvBN, "fuses_bn", lambda self, y: False)
            reset_launch_counts()
            out = pipe.run_fused(frames)
            counts.append((LAUNCHES["bn_silu_bf16"], LAUNCHES["bn_bf16"], LAUNCHES["silu_bf16"]))
            outs.append({**out, **raw[-1]})
    torch.cuda.synchronize()
    assert counts == [(silu, alone, 0), (0, 0, silu), (silu, alone, 0)]
    for key in outs[0]:
        for other in outs[1:]:
            assert torch.equal(outs[0][key], other[key]), key


def _state(c: int, dev, eps: float, seed: int):
    gen = torch.Generator().manual_seed(seed)
    mean = torch.randn(c, generator=gen) * 2
    var = torch.rand(c, generator=gen) * 4
    var[::7] = 0.0
    weight, bias = torch.randn(c, generator=gen), torch.randn(c, generator=gen)
    return [t.to(dev) for t in (mean, var, weight, bias)] + [eps]


@pytest.mark.gpu
@pytest.mark.parametrize("with_silu", [True, False])
@pytest.mark.parametrize("case", ["nchw", "nchw_hw_odd", "channels_last_307",
                                  "channels_last_tail", "channels_last_2048", "strided"])
@pytest.mark.parametrize("eps", [1e-3, 1e-5])
def test_bn_kernel_bit_equal_at_its_edges(cuda, with_silu, case, eps):
    """NCHW with H * W a multiple of 8 (vector path) and not (scalar),
    channels last at 307 channels (vector, channels across a group) and
    with a scalar tail, at 2,048 channels (the most the mode stages), a
    strided input (made contiguous, as ATen's contiguous kernel takes it:
    a strided one ATen computes in another order, so ``ConvBN`` never
    hands one over): bit-equal to ATen's eval BatchNorm then the act and
    to the plain version, one launch, the layout kept; zero variances
    included (ATen's invstd of eps alone)."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    shape = {"nchw_hw_odd": (3, 24, 7, 9), "channels_last_307": (2, 307, 20, 20),
             "channels_last_tail": (1, 12, 3, 5), "channels_last_2048": (2, 2048, 5, 5)}.get(
        case, (4, 24, 40, 40))
    x = (torch.randn(shape, generator=gen, device=cuda) * 4).bfloat16()
    if case.startswith("channels_last"):
        x = x.contiguous(memory_format=torch.channels_last)
    elif case == "strided":
        x = x[:, ::2]
    state = _state(x.shape[1], cuda, eps, seed=len(case))
    key = "bn_silu_bf16" if with_silu else "bn_bf16"
    before = LAUNCHES[key]
    got = act.batch_norm_act(x, *state, with_silu)
    assert LAUNCHES[key] == before + 1
    bn = torch.nn.functional.batch_norm(x.contiguous() if case == "strided" else x, *state[:4],
                                        False, 0.0, eps)
    want = act.silu(bn) if with_silu else bn
    plain = (act.batch_norm_silu_bf16_plain if with_silu else act.batch_norm_bf16_plain)(x, *state)
    torch.cuda.synchronize()
    if case.startswith("channels_last"):
        assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got), _bits(plain))


@pytest.mark.gpu
def test_invstd_is_atens_eval_invstd(cuda):
    """The plain version's (and the kernel's) ``rsqrt(var + eps)`` is the
    invstd ATen's eval BatchNorm computes and returns."""
    gen = torch.Generator().manual_seed(12)
    var = torch.cat([torch.rand(4096, generator=gen) * 8,
                     torch.exp(torch.randn(4096, generator=gen) * 6), torch.zeros(4)]).to(cuda)
    c = var.numel()
    x = torch.zeros((1, c, 1, 1), dtype=torch.bfloat16, device=cuda)
    ones, zeros = torch.ones(c, device=cuda), torch.zeros(c, device=cuda)
    for eps in (1e-3, 1e-5):
        invstd = torch.ops.aten.native_batch_norm(x, ones, zeros, zeros, var, False, 0.0, eps)[2]
        assert torch.equal(invstd, torch.rsqrt(var + eps))


@pytest.mark.gpu
def test_bn_wrapper_rejects_state_on_another_device(cuda):
    x = torch.zeros((2, 16, 8, 8), dtype=torch.bfloat16, device=cuda)
    state = _state(16, cuda, 1e-3, seed=0)
    state[1] = state[1].cpu()
    with pytest.raises(ValueError, match="var must be"):
        bn_act_bf16_cuda(x, *state, True)
