"""The harness's part of the YOLOv9-E cell: one raw state dict loads into
the plain reference and the port's trained form, the fan-ins' bytes of
``cardbench/cbfuse_counts.py`` against a hand count at a small shape and at
the cell's, and the two new readers on a synthetic trace."""

import json

import pytest
import torch

from cardbench import cbfuse_counts, spec, weights
from cardbench.metrics import _spans
from cardbench.metrics._empty_memsets import drop_empty_memsets
from cardbench.reference.two_stage import build_model
from tests.test_torch_cardbench_spans import _lost_operation, make_run

CELL = "yolov9e.card-b32-2048"
CONFIG = "yolov9e-shufflenetv2"


def _detector(size):
    return dict(spec.resolve(CELL).config["detector"], input_size=size)


def test_the_reference_and_the_port_load_one_raw_state_dict():
    from litepi_tpu_torch.models import YoloV9E

    det = _detector(64)
    state = weights.raw_state(det, 3, "cpu", 1, weights.BN_BIAS_STD)
    ref, port = build_model(det), YoloV9E(num_classes=1)
    ref.load_state_dict(state)
    port.load_state_dict(state)
    assert sum(k.endswith(".cv1.conv1.bn.running_var") for k in state) == 48
    assert state["cbl14.conv.bias"].shape == (64 + 128 + 256 + 512 + 1024,)
    assert weights.head_keys(det, "cls") == [f"head.cls{i}_out.{k}" for i in range(3)
                                             for k in ("weight", "bias")]


def test_cbfuse_counts_by_hand():
    b, s = 2, 64
    calls = cbfuse_counts.calls(_detector(s), b)
    # per level L (P1 = 32 at 64): the sources are the levels L..5, the
    # target level L, all with level L's width
    widths, sides = (64, 128, 256, 512, 1024), (32, 16, 8, 4, 2)
    assert [len(src) for src, _ in calls] == [5, 4, 3, 2, 1]
    for level, (sources, target) in enumerate(calls):
        c = widths[level]
        assert target == (b, c, sides[level], sides[level])
        assert sources == [(b, c, n, n) for n in sides[level:]]
    # the first fan-in: 64 channels of 32^2 + 16^2 + 8^2 + 4^2 + 2^2 read,
    # the 32^2 target read and the output written, 2 bytes each
    assert cbfuse_counts.bytes_of(*calls[0]) == 2 * b * 64 * (1364 + 2 * 1024)
    assert cbfuse_counts.bytes_of([(1, 2, 1, 1)], (1, 2, 3, 3)) == 2 * (2 + 2 * 18)


def test_cbfuse_bound_at_the_cell():
    calls = cbfuse_counts.calls(spec.resolve(CELL).config["detector"], 32)
    total = sum(cbfuse_counts.bytes_of(*c) for c in calls)
    assert total == 2 * 32 * sum(
        c * (sum((1280 >> j) ** 2 for j in range(level + 1, 6)) + 2 * (1280 >> level + 1) ** 2)
        for level, c in enumerate((64, 128, 256, 512, 1024)))
    assert total / 1e9 == pytest.approx(10.767, abs=0.001)
    assert cbfuse_counts.bound_s(CONFIG, 32) == pytest.approx(total / 3.35e12)


def _with_gelan(k, rows):
    """Batch k's rows with a GELAN block and a fan-in inside the detect
    span: under litepi.elan a memset of no bytes, a conv and a SiLU; under
    litepi.cbfuse a copy and two adds."""
    i = next(j for j, r in enumerate(rows) if r[0] == "litepi.detect")
    return rows[:i + 1] + [
        ("litepi.elan", (480, 590), [("cudaMemsetAsync", 482, 484, "", 0),
                                     ("cudaLaunchKernel", 485, 490, "sm90_xmma_fprop", 40),
                                     ("cudaLaunchKernel", 500, 505, "act_bias_vec_kernel", 20)]),
        ("litepi.cbfuse", (600, 700), [
            ("cudaLaunchKernel", 610, 615, "elementwise_kernel_copy", 30),
            ("cudaLaunchKernel", 620, 625, "vectorized_elementwise_kernel_add", 25),
            ("cudaLaunchKernel", 630, 635, "elementwise_kernel_add", 45)]),
    ] + rows[i + 1:]


def test_the_cell_resolves_and_its_readers_read_the_new_spans():
    cell = spec.resolve(CELL)
    det = cell.config["detector"]
    assert cell.chips == 1 and det["variant"] == "yolov9e" and det["reference"] == "yolov9"
    assert cell.config["reduced"] == [] and det["input_size"] == 1280 and det["num_classes"] == 1
    assert cell.traffic == json.loads((spec.HERE / "traffic" / "card-b32-2048.json").read_text())
    assert [m["name"] for m in cell.per_layer] == ["elan_ms.batch", "cbfuse_roofline"]
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s", "setup_s"}
    bound = cbfuse_counts.bound_s(CONFIG, 32)
    for batches in (1, 3):
        run = dict(make_run(batches, edit=_with_gelan), batch=32)
        run["device"] = [d for d in run["device"] if d[0]]  # the empty memset's
        assert _spans.pair(run) is None and _spans.pair(drop_empty_memsets(run)) is not None
        assert spec.reader("elan_ms.batch")(run) == pytest.approx((40 + 20) / 1e3)
        assert spec.reader("cbfuse_roofline")(run) == pytest.approx(100 * bound / 100e-6)
    # a kernel whose operation the trace lacks still refuses the pairing
    lost = dict(make_run(2, edit=lambda k, rows: _lost_operation(k, _with_gelan(k, rows))),
                batch=32)
    lost["device"] = [d for d in lost["device"] if d[0]]
    plain = dict(make_run(2), batch=32)  # paired, but no YOLOv9 spans: another model's
    for name in ("elan_ms.batch", "cbfuse_roofline"):
        assert spec.reader(name)(plain) is None and spec.reader(name)(lost) is None
        assert spec.reader(name)({"frames_per_s": 1.0}) is None
