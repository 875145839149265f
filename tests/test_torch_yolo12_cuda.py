"""YOLO12's attention core on the card (``gpu``; skips without one): SDPA's
flash kernel on the area views of a channels-last qkv agrees with the plain
version computed in float32 on the same bf16 values, and a call the flash
kernel cannot take raises rather than running another backend.  Imports
neither JAX nor the test helpers, so that it runs on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_yolo12_cuda.py``."""

import pytest
import torch

from litepi_tpu_torch.models.yolo12 import area_attention, attend_flash


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("area,grid", [(4, 80), (1, 40)])
def test_flash_core_matches_the_plain_version(cuda, area, grid):
    gen = torch.Generator(device=cuda).manual_seed(area)
    qkv = torch.randn((2, 3 * 256, grid, grid), generator=gen, device=cuda).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    o, v = area_attention(qkv, 8, area)
    want, want_v = area_attention(qkv.float(), 8, area)
    # bf16 output rounding of values within a few units: 2 ulp at 4
    torch.testing.assert_close(o.float(), want, atol=6e-2, rtol=0)
    assert torch.equal(v.float(), want_v)


@pytest.mark.gpu
def test_a_call_flash_cannot_take_raises(cuda):
    q = torch.randn((2, 8, 64, 32), device=cuda)
    with pytest.raises(RuntimeError):
        attend_flash(q, q, q)  # float32: no flash kernel, and no other backend may run
