"""YOLO-World's max-sigmoid core on the card (``gpu``; skips without one):
the bf16 chunked core agrees with the plain core computed in float32 on
the same bf16 values at P3's shape, is chunked in float32 too, keeps its
temporaries within ``MAXSIG_TEMP_BYTES`` at the cell's batch in bf16 and
in float32, and ``run_fused`` with the
``yoloworldv2l`` variant calls it 4 times.  Imports neither JAX nor the
test helpers, so that it runs on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_yoloworld_cuda.py``."""

import pytest
import torch

from litepi_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from litepi_tpu_torch.models.yoloworld import (
    MAXSIG_TEMP_BYTES,
    max_sigmoid_attention,
    max_sigmoid_plain,
    maxsig_chunk,
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
