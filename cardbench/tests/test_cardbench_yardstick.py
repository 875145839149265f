"""The yardstick's arithmetic on hand-made shapes and events: the copied
bound formulas, the FLOP count, busy time and the idle share, the idle
gaps, and the share of straying frames that decides ``correct``."""

import pytest
import torch
from torch import nn

from cardbench import judge, yardstick
from cardbench.metrics import _common


def test_stem_counts_and_bound_at_the_serving_shape():
    n_bytes, n_ops = yardstick.stem_counts(128, 640, 640, 16)
    n_out = 128 * 16 * 320 * 320
    assert n_bytes == 128 * 640 * 640 * 3 + 2 * n_out + 4 * 28 * 16
    assert n_ops == n_out * 58
    # operations bound it: 12.16 GFLOP at 67 TFLOP/s
    assert yardstick.bound_s(n_bytes, n_ops) == pytest.approx(n_ops / 67e12)
    assert yardstick.bound_s(n_bytes, n_ops) * 1e3 == pytest.approx(0.1815, rel=1e-3)


def test_roi_counts_count_each_touched_byte_once():
    # one valid 64x64 box sampled at 64x64: every tap row and column distinct
    boxes = torch.tensor([[[10.0, 20.0, 74.0, 84.0], [0.0, 0.0, 5.0, 5.0]]])
    valid = torch.tensor([[True, False]])
    n_bytes, n_ops = yardstick.roi_counts(boxes, valid, 640, 640, 64)
    rows = cols = 65  # 64 half-pixel samples over 64 pixels touch 65 lines
    assert n_bytes == rows * cols * 3 + boxes.numel() * 4 + 2 + 2 * 64 * 64 * 3 * 4
    assert n_ops == 9 * 64 * 64 * 3


def test_model_flops_count_a_conv():
    flops = yardstick.model_flops(lambda: nn.Conv2d(3, 8, 3, padding=1, bias=False),
                                  (2, 3, 10, 10))
    assert flops == 2 * (2 * 8 * 10 * 10) * (3 * 3 * 3)


def test_union_and_idle_share():
    events = [("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("d", 90, 120)]
    assert yardstick.union_ns(events, 0, 100) == 20 + 10 + 10
    run = {"window_ns": (0, 100), "device": events, "loop": "closed"}
    assert _common.idle_pct(run) == pytest.approx(60.0)


def test_idle_gaps_are_named_by_the_host_span_open_at_their_start():
    device = [("k", 0, 10), ("k", 50, 70)]
    host = [("cardbench.window", 0, 100), ("cardbench.issue", 5, 60), ("cudaLaunch", 12, 14)]
    gaps = yardstick.idle_gaps(device, host, 0, 100)
    assert gaps[0] == ["cardbench.issue", pytest.approx(40e-9)]  # 10..50
    assert gaps[1] == ["cardbench.window", pytest.approx(30e-9)]  # 70..100


def test_kernel_kinds():
    assert yardstick.kind_of("sm90_xmma_fprop_implicit_gemm_bf16") == "conv_gemm"
    assert yardstick.kind_of("stem_tiled_kernel") == "stem_kernel"
    assert yardstick.kind_of("Memcpy HtoD (Pageable -> Device)") == "memcpy"


def test_roofline_reader_divides_bound_by_mean_device_time():
    run = {"window_ns": (0, 10**9), "stem_counts": (0, 67e9),  # 1 ms of operations
           "device": [("stem_tiled_kernel", 0, 2 * 10**6), ("stem_tiled_kernel", 10**7, 10**7 + 2 * 10**6)]}
    assert _common.roofline_pct(run, "stem_counts", ("stem_tiled_kernel",)) == pytest.approx(50.0)
    assert _common.roofline_pct({"window_ns": (0, 1), "device": []}, "stem_counts", ("x",)) is None


def test_stray_share_counts_frames_past_the_cut_over_the_renderings_tail():
    # 101 frames; the rendering's 90th percentile of each per-frame gap is
    # 0.9 (box 1.8), so the cuts are STRAY times that
    ramp = torch.linspace(0.0, 1.0, 101)
    yard = {"frame_viol": ramp, "frame_box": 2 * ramp, "frame_score": ramp}
    prog = {k: v.clone() for k, v in yard.items()}
    assert judge.stray_share(prog, yard) == (0.0, 0.0)
    cut = judge.STRAY * 0.9
    # 30 frames off by one kind of gap each, past the cut; 10 below it
    prog["frame_viol"][:10] = cut * 1.05
    prog["frame_box"][10:20] = 2 * cut * 1.05
    prog["frame_score"][20:30] = cut * 1.05
    prog["frame_viol"][30:40] = cut * 0.95
    share, own = judge.stray_share(prog, yard)
    assert share == pytest.approx(30 / 101) and own == 0.0


def test_verdict_compares_the_numbers_the_limits_name():
    numbers = {"box": 1.0, "score": 1.0, "choice": 9.0, "prob": 1.0, "stray": 0.01}
    assert judge.verdict(numbers, {"box": 2.0, "stray": 0.1})
    assert not judge.verdict(numbers, {"box": 2.0, "choice": 3.0})
    assert not judge.verdict(dict(numbers, box=float("nan")), {"box": 2.0})
    assert not judge.verdict(numbers, {})
