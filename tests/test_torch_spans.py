"""The stage spans of ``run_fused`` (``core/metrics.py::span``): under a
profiler each call gives one ``litepi.run_fused`` span holding the seven
stage spans in order; with no profiler ``span`` is one shared null context
and never reaches ``record_function``; the outputs are the same bit for bit
either way.  A tiny seeded pipeline on the CPU, with the default detector
and with an injected YOLOv11n.
"""

import contextlib
import functools
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from litepi_tpu_torch.core import metrics
from litepi_tpu_torch.core.types import DetectorConfig, NMSConfig, PipelineConfig
from litepi_tpu_torch.models import detector_kwargs
from litepi_tpu_torch.pipeline import TwoStagePipeline
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STAGES = ("stem", "detect", "candidates", "suppress", "unmap", "crop", "classify")
CFG = PipelineConfig(
    detector=DetectorConfig(name="tiny", base_channels=(16, 32, 64, 128, 256), input_size=64),
    nms=NMSConfig(conf_threshold=0.0, max_candidates=16, max_detections=4, min_area=0.0),
    classifier_arch="shufflenetv2",
    num_classifier_classes=5,
    det_input_size=64,
    cls_input_size=32,
    benchmark_conf=0.0,
    crop_det_budget=3,
    input_color="bgr",
    cls_crop_budget=4,
)


@functools.lru_cache(maxsize=None)
def _pipeline(variant):
    kwargs = detector_kwargs(variant, CFG, "cpu") if variant else {}
    return TwoStagePipeline.initialize(CFG, seed=3, device="cpu", **kwargs)


@pytest.fixture(params=[None, "yolov11n"], ids=["default", "yolov11n"])
def pipe(request):
    return _pipeline(request.param)


def _frames(shape=(2, 64, 64, 3)):
    return torch.as_tensor(np.random.default_rng(7).integers(0, 256, shape, dtype=np.uint8))


def _litepi_spans(prof):
    """(name, start ns, end ns) of every ``litepi.*`` span, in start order."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.name().startswith("litepi.")]
    return sorted(out, key=lambda x: (x[1], -x[2]))


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (2, 48, 80, 3)], ids=["canvas", "letterbox"])
def test_each_call_gives_one_root_with_the_stages_in_order(pipe, shape):
    frames = _frames(shape)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            pipe.run_fused(frames)
    spans = _litepi_spans(prof)
    roots = [s for s in spans if s[0] == "litepi.run_fused"]
    assert len(roots) == 2
    assert {n for n, _, _ in spans} == {"litepi.run_fused"} | {f"litepi.{s}" for s in STAGES}
    for _, lo, hi in roots:
        inside = [s for s in spans if lo <= s[1] and s[2] <= hi and s[0] != "litepi.run_fused"]
        assert [n for n, _, _ in inside] == [f"litepi.{s}" for s in STAGES]
        # siblings: each stage ends before the next begins
        assert all(a[2] <= b[1] for a, b in zip(inside, inside[1:]))


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first, second = metrics.span("stem"), metrics.span("classify")
    assert first is second and isinstance(first, contextlib.nullcontext)
    with first:
        pass


def test_span_under_a_profiler_names_the_stage():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.span("detect"):
            torch.ones(2).add_(1)
    assert [s[0] for s in _litepi_spans(prof)] == ["litepi.detect"]


def test_outputs_with_spans_on_equal_outputs_with_spans_off(pipe):
    frames = _frames()
    off = pipe.run_fused(frames)
    with profile(activities=[ProfilerActivity.CPU]):
        on = pipe.run_fused(frames)
    assert off.keys() == on.keys()
    for k in off:
        assert off[k].dtype == on[k].dtype
        assert torch.equal(off[k], on[k]), k


def test_the_injected_detector_frees_the_stems_canvas_before_it_runs(monkeypatch):
    # run_fused keeps no reference to the stem's output, so the BGR -> RGB
    # flip frees the canvas before the detector runs, as without spans
    pipe = _pipeline("yolov11n")
    assert pipe.cfg.input_color == "bgr"
    canvas, alive = [], []
    stem, forward = pipe._stem, pipe.det_model.forward

    def kept_stem(frames):
        out = stem(frames)
        canvas.append(weakref.ref(out))
        return out

    def watched_forward(x):
        alive.append(canvas[-1]() is not None)
        return forward(x)

    monkeypatch.setattr(pipe, "_stem", kept_stem)
    monkeypatch.setattr(pipe.det_model, "forward", watched_forward)
    pipe.run_fused(_frames())
    assert alive == [False]
