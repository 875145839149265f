"""The ADown front ends' bytes of ``cardbench/adown_counts.py`` against a
hand count at a small shape and at the YOLOv9-E cell's, and the
``adown_roofline`` reader on a synthetic trace and on one without the
span."""

import pytest

from cardbench import adown_counts, spec
from cardbench.metrics._empty_memsets import drop_empty_memsets
from tests.test_torch_cardbench_spans import make_run

CELL = "yolov9e.card-b32-2048"
CONFIG = "yolov9e-shufflenetv2"


def test_adown_counts_by_hand():
    b, s = 2, 64
    det = dict(spec.resolve(CELL).config["detector"], input_size=s)
    # down4, down6, down8 in the first backbone, down20, down23, down26 in
    # the second, down36 and down39 in the head: P2, P3, P4 inputs twice,
    # then P3 and P4 again
    assert adown_counts.calls(det, b) == [
        (b, 256, 16, 16), (b, 512, 8, 8), (b, 1024, 4, 4)] * 2 + [(b, 256, 8, 8), (b, 512, 4, 4)]
    # 16x16 in, 15x15 averaged (first half), 8x8 pooled (second half)
    assert adown_counts.bytes_of((b, 256, 16, 16)) == 2 * b * (256 * 256 + 128 * (225 + 64))
    # odd sizes: 7x9 in, 6x8 averaged, 3x4 pooled
    assert adown_counts.bytes_of((1, 32, 7, 9)) == 2 * (32 * 63 + 16 * (48 + 12))


def test_adown_bound_at_the_cell():
    calls = adown_counts.calls(spec.resolve(CELL).config["detector"], 32)
    assert len(calls) == 8
    total = sum(adown_counts.bytes_of(c) for c in calls)
    assert total == 10_527_842_304
    assert adown_counts.bound_s(CONFIG, 32) == pytest.approx(total / 3.35e12)
    assert adown_counts.bound_s(CONFIG, 32) * 1e3 == pytest.approx(3.143, abs=0.001)


def _with_adown(k, rows):
    """Batch k's rows with an ADown front end inside the detect span: one
    kernel under litepi.adown, then a conv outside it."""
    i = next(j for j, r in enumerate(rows) if r[0] == "litepi.detect")
    return rows[:i + 1] + [
        ("litepi.adown", (480, 520), [("cudaLaunchKernel", 485, 490, "adown_front_kernel", 80)]),
    ] + rows[i + 1:]


def test_the_reader_reads_the_adown_span():
    reader = spec.reader("adown_roofline")
    assert "adown_roofline" in [m["name"] for m in spec.resolve(CELL).per_layer]
    bound = adown_counts.bound_s(CONFIG, 32)
    for batches in (1, 3):
        run = drop_empty_memsets(dict(make_run(batches, edit=_with_adown), batch=32))
        assert reader(run) == pytest.approx(100 * bound / 80e-6)
    # a trace without the span (another model, or a program without it)
    # reads nothing, as does a line without a trace
    assert reader(dict(make_run(2), batch=32)) is None
    assert reader({"frames_per_s": 1.0}) is None
