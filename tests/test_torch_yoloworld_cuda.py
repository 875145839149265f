"""YOLO-World's max-sigmoid core and class-head GEMM on the card (``gpu``;
skips without one): the bf16 chunked core agrees with the plain core
computed in float32 on the same bf16 values at P3's shape, is chunked in
float32 too, keeps its temporaries within ``MAXSIG_TEMP_BYTES`` at the
cell's batch in bf16 and in float32; the class-head GEMM
(``kernels/vocab.py``) agrees with the three passes it replaces at the
cell's three levels and at ragged shapes, writes only its own rows and
raises on what it does not take, called alone and through the head; and
``run_fused`` with the ``yoloworldv2l`` variant calls the core 4 times and
the GEMM 3 times, with no conv under the ``litepi.vocab`` span.  Imports neither JAX nor the test
helpers, so that it runs on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_yoloworld_cuda.py``."""

import pytest
import torch
import torch.nn.functional as F

from litepi_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from litepi_tpu_torch.kernels.vocab import (
    takes_vocab_kernel,
    vocab_logits_cuda,
    vocab_logits_plain,
)
from litepi_tpu_torch.models.yoloworld import (
    MAXSIG_TEMP_BYTES,
    add_world_head,
    max_sigmoid_attention,
    max_sigmoid_plain,
    maxsig_chunk,
    world_head,
)

NC = 1203


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(cuda, batch, c=128, grid=160, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    heads = c // 32
    x = (torch.randn((batch, c, grid, grid), generator=gen, device=cuda) * 3).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    guide = (torch.randn((heads * NC, 32, 1, 1), generator=gen, device=cuda) / 32 ** 0.5).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    bias = torch.randn((heads,), generator=gen, device=cuda).to(torch.bfloat16)
    return x, guide, bias, heads


@pytest.mark.gpu
def test_the_bf16_core_matches_the_plain_core_at_p3(cuda):
    x, guide, bias, heads = _inputs(cuda, 1)
    reset_launch_counts()
    got = max_sigmoid_attention(x, guide, bias, heads)
    assert LAUNCHES["maxsig"] == 1
    want = max_sigmoid_plain(x.float(), guide.float(), bias.float(), heads)
    assert got.shape == want.shape == (1, heads, 160, 160) and got.dtype == torch.float32
    # the one bf16 rounding of each chunk's best score (about 10, 2^-5
    # apart) moves its logit by 6e-3 at most and the sigmoid by a quarter of that
    torch.testing.assert_close(got, want, atol=2e-3, rtol=0)


@pytest.mark.gpu
def test_a_float32_core_on_the_card_is_chunked_and_matches_the_plain_core(cuda):
    x, guide, bias, heads = _inputs(cuda, 1)
    x, guide, bias = x.float(), guide.float(), bias.float()
    assert -(-NC // maxsig_chunk(x, heads, NC)) == 1  # one frame's scores fit whole
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = max_sigmoid_attention(x, guide, bias, heads)
        want = max_sigmoid_plain(x, guide, bias, heads)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, pieces", [(torch.bfloat16, 4), (torch.float32, 8)])
def test_the_cores_temporaries_stay_within_the_limit_at_the_cells_batch(cuda, dtype, pieces):
    x, guide, bias, heads = _inputs(cuda, 32)
    x, guide, bias = x.to(dtype), guide.to(dtype), bias.to(dtype)
    assert -(-NC // maxsig_chunk(x, heads, NC)) == pieces
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    before = torch.cuda.memory_allocated(cuda)
    out = max_sigmoid_attention(x, guide, bias, heads)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated(cuda) - before
    # one chunk's scores, its max, the running max and the output beside them
    assert MAXSIG_TEMP_BYTES // 2 < grown < MAXSIG_TEMP_BYTES + 3 * out.numel() * 4 + (64 << 20)


@pytest.mark.gpu
def test_run_fused_calls_the_core_four_times(cuda):
    from cardbench import program, spec, traffic
    from cardbench.weights import make_states

    cfg = spec.resolve("yoloworldv2l.card-b32-2048").config
    cfg = dict(cfg, detector=dict(cfg["detector"], input_size=256))
    det, cls = make_states(cfg, 5, cuda)
    run_fused = program.build(cfg, det, cls, 2, cuda)
    frames = traffic.make_frames(5, 0, 2, 320, 400, cuda)
    run_fused(frames)
    reset_launch_counts()
    out = run_fused(frames)
    torch.cuda.synchronize()
    assert LAUNCHES["maxsig"] == 4
    assert out["valid"].shape[0] == 2


def _class_head(cuda, b, k, h, w, nc, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((b, k, h, w), generator=gen, device=cuda).bfloat16().contiguous(
        memory_format=torch.channels_last)
    weight = (torch.randn((nc, k, 1, 1), generator=gen, device=cuda) * 3 / k ** 0.5).bfloat16()
    bias = torch.randn(nc, generator=gen, device=cuda).bfloat16()
    return x, weight, bias


@pytest.mark.gpu
@pytest.mark.parametrize("b, k, h, w, nc", [
    (32, 512, 160, 160, NC), (32, 512, 80, 80, NC), (32, 512, 40, 40, NC),  # the cell's levels
    (1, 512, 8, 8, 1), (1, 512, 8, 8, 80), (3, 512, 7, 9, 80),  # M no multiple of 128
    (1, 64, 40, 40, NC), (5, 128, 20, 20, 129)])
def test_the_class_head_gemm_matches_the_passes_it_replaces(cuda, b, k, h, w, nc):
    """Every value within 2 bf16 ulps of max(|want|, |c|), c the conv's
    bf16 output before its bias: the kernel and cuDNN sum the same float32
    products in other orders, which moves the sum by far less than a bf16
    ulp of it, so c's rounding by one ulp at most and the bias add's
    rounding by one more.  The rows before a0 = 5 and after the level's
    stay untouched."""
    x, weight, bias = _class_head(cuda, b, k, h, w, nc)
    outs = [torch.full((b, h * w + 7, nc), float("nan"), device=cuda) for _ in range(2)]
    reset_launch_counts()
    with torch.inference_mode():
        vocab_logits_cuda(x, weight, bias, outs[0], 5)
        vocab_logits_plain(x, weight, bias, outs[1], 5)
    assert LAUNCHES["vocab_gemm"] == 1
    got, want = outs[0][:, 5:5 + h * w], outs[1][:, 5:5 + h * w]
    assert outs[0][:, :5].isnan().all() and outs[0][:, 5 + h * w:].isnan().all()
    differ = worst = 0
    for i in range(b):
        c = F.conv2d(x[i:i + 1], weight).permute(0, 2, 3, 1).reshape(h * w, nc).float()
        unit = torch.ldexp(torch.ones_like(c), torch.frexp(
            torch.maximum(want[i].abs(), c.abs())).exponent - 8)
        err = (got[i] - want[i]).abs()
        differ += int((err > 0).sum())
        worst = max(worst, float((err / unit).max()))
    print(f"({b}, {k}, {h}, {w}) nc={nc}: {differ / got.numel():.3g} of the values not "
          f"bit-equal, at most {worst} bf16 ulps")
    assert worst <= 2


@pytest.mark.gpu
def test_the_class_head_gemm_raises_on_what_it_does_not_take(cuda):
    x, weight, bias = _class_head(cuda, 1, 96, 4, 4, 80)
    out = torch.empty((1, 16, 80), device=cuda)
    with pytest.raises(ValueError, match="multiple of 64"):
        vocab_logits_cuda(x, weight, bias, out, 0)
    x, weight, bias = _class_head(cuda, 1, 64, 4, 4, 80)
    with pytest.raises(ValueError, match="channels-last"):
        vocab_logits_cuda(x.contiguous(), weight, bias, out, 0)
    with pytest.raises(ValueError, match="float32"):
        vocab_logits_cuda(x, weight, bias, out.bfloat16(), 0)
    conv = torch.nn.Conv2d(64, 80, 1).to(cuda)
    with torch.inference_mode():
        assert takes_vocab_kernel(x, conv)
        assert not takes_vocab_kernel(x.float(), conv)
        assert takes_vocab_kernel(x.contiguous(), conv)  # and the kernel raises on it
    assert not takes_vocab_kernel(x, conv)  # autograd records the conv


@pytest.mark.gpu
def test_world_head_raises_on_a_bf16_head_input_the_kernel_cannot_take(cuda):
    """On the card in bf16 the head has no way back to cuDNN: an NCHW
    input reaches the kernel's layout check and raises; channels last runs
    the kernel once per level."""
    head = torch.nn.Module()
    add_world_head(head, (64, 64, 64), 80, 16)
    head = head.eval().to(cuda, torch.bfloat16)
    gen = torch.Generator(device=cuda).manual_seed(3)
    feats = [torch.randn((2, 64, s, s), generator=gen, device=cuda).bfloat16() for s in (8, 4, 2)]
    reset_launch_counts()
    with torch.inference_mode():
        with pytest.raises(ValueError, match="channels-last"):
            world_head(head, feats)
        assert LAUNCHES["vocab_gemm"] == 0
        out = world_head(head, [f.contiguous(memory_format=torch.channels_last) for f in feats])
    assert LAUNCHES["vocab_gemm"] == 3
    assert out["cls"].shape == (2, 64 + 16 + 4, 80) and out["cls"].isfinite().all()


@pytest.mark.gpu
def test_run_fused_runs_the_class_head_as_three_gemms(cuda):
    from torch.profiler import ProfilerActivity, profile

    from cardbench import program, spec, traffic
    from cardbench.weights import make_states

    cfg = spec.resolve("yoloworldv2l.card-b32-2048").config
    cfg = dict(cfg, detector=dict(cfg["detector"], input_size=256))
    det, cls = make_states(cfg, 5, cuda)
    run_fused = program.build(cfg, det, cls, 2, cuda)
    frames = traffic.make_frames(5, 0, 2, 320, 400, cuda)
    run_fused(frames)
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_fused(frames)
        torch.cuda.synchronize()
    assert LAUNCHES["vocab_gemm"] == 3
    events = prof.events()
    assert sum(e.name == "litepi.vocab" and e.device_type == torch.autograd.DeviceType.CPU
               for e in events) == 3
    gemms = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
             and "vocab_gemm_kernel" in e.name]
    assert len(gemms) == 3

    def in_vocab(e):
        while e is not None:
            if e.name == "litepi.vocab":
                return True
            e = e.cpu_parent
        return False

    convs = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU
             and "conv" in e.name and in_vocab(e)]
    assert not convs
