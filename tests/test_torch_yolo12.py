"""YOLO12-L in the port (``litepi_tpu_torch/models/yolo12.py``) against the
benchmark's plain float32 reference (``cardbench/reference/yolo12.py``),
on the CPU, one torch thread; no JAX package has this model.

Weights are ``cardbench.weights.make_states``'s (``raw_state`` draws,
BatchNorm calibrated on seeded frames, output layers scaled) for the
``yolo12l-shufflenetv2`` configuration at a 128x128 input: every width and
depth as published, the P4 grid 8x8 (four strips of 16 tokens), P5 4x4.
Also: the area-attention core against attention computed strip by strip by
hand, the gamma-scaled residual, the parameter count, ``run_fused`` with the
``yolo12l`` variant on letterboxed frames against the reference pipeline,
the e2e CLI with ``--detector_variant yolo12l``, the new cell's files and
its two readers.  The flash kernel's pinning on the card:
``tests/test_torch_yolo12_cuda.py``.
"""

import math
import os

import cv2
import numpy as np
import pytest
import torch

from cardbench import attn_counts, judge, program, spec, traffic
from cardbench.metrics import _spans
from cardbench.metrics._empty_memsets import drop_empty_memsets
from cardbench.reference.two_stage import Reference, build_model
from cardbench.weights import make_states
from litepi_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from litepi_tpu_torch.models import Yolo12L
from litepi_tpu_torch.models.yolo12 import A2C2f, area_attention
from tests.test_torch_cardbench_spans import BATCH, _lost_operation, make_run
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture, used by pytestmark)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CELL = "yolo12l.card-b32-2048"
SIZE = 128
# float32 sums in other orders (the port's convs channels last, the
# reference's NCHW; the attention's products per head and strip) over the
# model's 211 convs: measured 3.4e-6 of the largest logit at most; a bf16
# step anywhere would move them by ~4e-3 of it
HEAD_RTOL = 2e-5


def small_config(dtype="float32"):
    cfg = spec.resolve(CELL).config
    return dict(cfg, detector=dict(cfg["detector"], input_size=SIZE),
                serving=dict(cfg["serving"], dtype=dtype))


@pytest.fixture(scope="module")
def states():
    return make_states(small_config(), 11, "cpu")


def test_yolo12l_matches_the_reference_in_float32(states):
    det, _ = states
    cfg = small_config()
    model = Yolo12L(num_classes=1).eval()
    model.load_state_dict(det)
    ref = build_model(cfg["detector"]).eval()
    ref.load_state_dict(det)
    x = torch.rand((2, 3, SIZE, SIZE), generator=torch.Generator().manual_seed(3))
    reset_launch_counts()
    with torch.no_grad():
        got, want = model(x), ref(x)
    assert LAUNCHES["area_attn"] == 16
    assert got["reg"].shape == (2, 16 * 16 + 8 * 8 + 4 * 4, 64) and got["cls"].shape == (2, 336, 1)
    for k in ("reg", "cls"):
        assert got[k].dtype == torch.float32
        peak = float(want[k].abs().max())
        assert peak > 1.0  # logits of a few units: the calibrated head does work
        torch.testing.assert_close(got[k], want[k], atol=HEAD_RTOL * peak, rtol=0)


def _by_hand(qkv, heads, area):
    """Attention strip by strip and head by head, the qkv channels read as
    [q | k | v] per head of 32."""
    b, c3, h, w = qkv.shape
    c, rows = c3 // 3, h // area
    o = torch.zeros((b, c, h, w), dtype=torch.float64)
    v_out = torch.zeros_like(o)
    for j in range(area):
        strip = qkv[:, :, j * rows:(j + 1) * rows].double().flatten(2)  # (B, 3C, tokens)
        for hd in range(heads):
            q, k, v = (strip[:, hd * 96 + 32 * i: hd * 96 + 32 * (i + 1)] for i in range(3))
            attn = torch.softmax(q.transpose(1, 2) @ k / math.sqrt(32), dim=-1)
            o[:, hd * 32:(hd + 1) * 32, j * rows:(j + 1) * rows] = (
                v @ attn.transpose(1, 2)).reshape(b, 32, rows, w)
            v_out[:, hd * 32:(hd + 1) * 32, j * rows:(j + 1) * rows] = v.reshape(b, 32, rows, w)
    return o, v_out


@pytest.mark.parametrize("area,layout", [(4, torch.channels_last), (4, torch.contiguous_format),
                                         (1, torch.channels_last)])
def test_area_attention_is_attention_within_each_strip(area, layout):
    gen = torch.Generator().manual_seed(area)
    qkv = (torch.randn((2, 3 * 64, 8, 6), generator=gen) * 2).contiguous(memory_format=layout)
    o, v = area_attention(qkv, 2, area)
    want_o, want_v = _by_hand(qkv, 2, area)
    assert o.shape == v.shape == (2, 64, 8, 6)
    assert o.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(o.double(), want_o, atol=1e-5, rtol=0)
    assert torch.equal(v.double(), want_v)
    # head-major: swapping head 0's q and k moves only head 0's output
    swapped = qkv.clone()
    swapped[:, 0:32], swapped[:, 32:64] = qkv[:, 32:64], qkv[:, 0:32]
    o2, _ = area_attention(swapped, 2, area)
    assert not torch.allclose(o2[:, :32], o[:, :32]) and torch.equal(o2[:, 32:], o[:, 32:])


def test_gamma_scales_the_area_attention_residual():
    torch.manual_seed(0)
    block = A2C2f(64, 64, n=1, a2=True, area=1).eval()
    assert block.gamma.shape == (64,) and torch.all(block.gamma == 0.01)
    assert A2C2f(64, 64, 1, a2=False).gamma is None
    x = torch.randn((2, 64, 4, 4))
    gamma = torch.linspace(-1.0, 1.0, 64)
    with torch.no_grad():
        y0 = block.cv1(x)
        inner = block.cv2(torch.cat([y0, block.m0(y0)], dim=1))
        block.gamma.copy_(gamma)
        torch.testing.assert_close(block(x), x + gamma[None, :, None, None] * inner)
        block.gamma.zero_()
        assert torch.equal(block(x), x)


def test_parameter_count_at_80_classes():
    cfg = dict(small_config()["detector"], num_classes=80)
    with torch.device("meta"):
        ref, port = build_model(cfg), Yolo12L(num_classes=80)
    n = sum(p.numel() for p in ref.parameters())
    assert n == sum(p.numel() for p in port.parameters())
    assert set(ref.state_dict()) == set(port.state_dict())
    # the equations (layers 1 and 3 grouped 2 and 4) and the 16 weights of
    # the DFL conv; the yaml's summary, 26,450,784, is this model with
    # those two convs ungrouped: 64*128*9 / 2 and 256*256*9 * 3/4 more
    assert n + 16 == 25_971_552
    assert n + 16 + 64 * 128 * 9 // 2 + 256 * 256 * 9 * 3 // 4 == 26_450_784


def test_run_fused_with_yolo12l_matches_the_reference_pipeline(states):
    det, cls = states
    cfg = small_config()
    frames = traffic.make_frames(11, 0, 2, 200, 200, "cpu")
    run_fused = program.build(cfg, det, cls, 2, "cpu")
    reset_launch_counts()
    got = run_fused(frames)
    assert LAUNCHES["area_attn"] == 16
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


def test_e2e_cli_runs_yolo12l(tmp_path):
    from litepi_tpu_torch.apps import e2e

    images, labels, out = (str(tmp_path / k) for k in ("images", "labels", "out"))
    os.makedirs(images), os.makedirs(labels)
    rng = np.random.default_rng(0)
    for i in range(2):
        cv2.imwrite(os.path.join(images, f"img{i}.jpg"),
                    rng.integers(0, 256, (160, 200, 3), dtype=np.uint8))
    with open(os.path.join(labels, "img0.txt"), "w") as f:
        f.write("3 0.5 0.5 0.2 0.2\n")
    common = ["--input", images, "--labels", labels, "--output", out, "--device", "cpu",
              "--detector_variant", "yolo12l", "--det_input_size", str(SIZE), "--batch_size", "2",
              "--max_det", "8", "--max_candidates", "64", "--num_samples", "2", "--warmup", "0"]
    assert e2e.main(common) == 0
    assert os.path.isfile(os.path.join(out, "comparison_summary.csv"))
    assert e2e.main(common + ["--detector", "best.pt"]) == 2


def _with_ablocks(k, rows):
    """Batch k's rows with an ABlock inside the detect span: under
    litepi.ablock a memset of no bytes (no device operation, as cuDNN's
    307-channel convs issue) and a conv, then a copy and SDPA's flash
    kernel under litepi.attn."""
    i = next(j for j, r in enumerate(rows) if r[0] == "litepi.detect")
    return rows[:i + 1] + [
        ("litepi.ablock", (480, 890), [("cudaMemsetAsync", 482, 484, "", 0),
                                       ("cudaLaunchKernel", 485, 490, "sm90_xmma_fprop", 40)]),
        ("litepi.attn", (600, 700), [
            ("cudaLaunchKernel", 610, 615, "elementwise_kernel_copy", 20),
            ("cudaLaunchKernel", 620, 625,
             "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<32>>", 100)]),
    ] + rows[i + 1:]


def test_the_cell_resolves_and_its_readers_read_the_new_spans():
    cell = spec.resolve(CELL)
    assert cell.chips == 1 and cell.config["detector"]["variant"] == "yolo12l"
    assert cell.config["reduced"] == [] and cell.config["detector"]["input_size"] == 1280
    assert (cell.traffic["batch"], cell.traffic["height"], cell.traffic["width"]) == (32, 2048, 2048)
    assert [m["name"] for m in cell.per_layer] == ["ablock_ms.batch", "attn_roofline"]
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s", "setup_s"}
    assert len(BATCH) == 7
    for batches in (1, 3):
        run = dict(make_run(batches, edit=_with_ablocks), batch=32)
        run["device"] = [d for d in run["device"] if d[0]]  # the empty memset's
        assert _spans.pair(run) is None and _spans.pair(drop_empty_memsets(run)) is not None
        assert spec.reader("ablock_ms.batch")(run) == pytest.approx((40 + 20 + 100) / 1e3)
        bound = attn_counts.bound_s("yolo12l-shufflenetv2", 32)
        assert spec.reader("attn_roofline")(run) == pytest.approx(100 * bound / 100e-6)
    # a kernel whose operation the trace lacks still refuses the pairing
    lost = dict(make_run(2, edit=lambda k, rows: _lost_operation(k, _with_ablocks(k, rows))),
                batch=32)
    lost["device"] = [d for d in lost["device"] if d[0]]
    plain = dict(make_run(2), batch=32)  # paired, but no ABlock spans: YOLO11's trace
    for name in ("ablock_ms.batch", "attn_roofline"):
        assert spec.reader(name)(plain) is None and spec.reader(name)(lost) is None
        assert spec.reader(name)({"frames_per_s": 1.0}) is None


def test_attention_counts_of_the_cell():
    detector = spec.resolve(CELL).config["detector"]
    calls = attn_counts.calls(detector, 32)
    # 8 ABlocks at P4 (80x80 in 4 strips) and 8 at P5 (40x40, one area)
    assert calls == [(128, 8, 1600, 32)] * 8 + [(32, 8, 1600, 32)] * 8
    ops = sum(attn_counts.counts(*c)[0] for c in calls)
    assert ops / 32 == pytest.approx(104.8576e9)
