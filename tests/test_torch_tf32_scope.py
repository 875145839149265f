"""A float32 ``TwoStagePipeline`` sets the TF32 flags around its own calls
only: its entry points (``run_fused``, ``detect``, ``detect_candidates``,
``classify``, and ``StreamingRunner`` through ``run_fused``) compute with
TF32 as the pipeline's ``allow_tf32`` says (off by default) and give the
caller's flags back, whichever they were; constructing one changes no flag;
a bf16 pipeline computes under the caller's flags.  The e2e CLI's
``--matmul_precision high`` still reaches the float32 rows' computation,
and the CLI leaves the process's flags as it found them.  (The flags act on
the card only; here the tests read them where the models run.)"""

import os

import cv2
import numpy as np
import pytest
import torch

from litepi_tpu_torch.models import yolo as yolo_mod
from litepi_tpu_torch.pipeline import StreamingRunner, TwoStagePipeline
from tests.torch_port_helpers import (
    SMALL,
    canvas_frames,
    one_torch_thread,  # noqa: F401 (a fixture, used by pytestmark)
    peaked_frames,
    port_config,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def _set(value):
    torch.backends.cudnn.allow_tf32 = value
    torch.backends.cuda.matmul.allow_tf32 = value


@pytest.fixture
def seen(monkeypatch):
    """The flags each detector and classifier forward ran under."""
    saved = _flags()
    record = []
    real = yolo_mod.YoloLitePi.forward
    monkeypatch.setattr(yolo_mod.YoloLitePi, "forward",
                        lambda self, *a, **k: (record.append(_flags()), real(self, *a, **k))[1])
    yield record
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _calls(pipe):
    frames = peaked_frames(seed=11, batch=2, h=200, w=300)
    canvas = canvas_frames().astype(np.float32) / 255
    crops = np.random.default_rng(0).uniform(0, 1, (3, 64, 64, 3)).astype(np.float32)
    return {
        "run_fused": lambda: pipe.run_fused(frames),
        "detect": lambda: pipe.detect(canvas),
        "detect_candidates": lambda: pipe.detect_candidates(canvas),
        "classify": lambda: pipe.classify(crops),
    }


@pytest.mark.parametrize("caller", [True, False])
@pytest.mark.parametrize("allow", [False, True])
def test_float32_pipeline_scopes_the_flags(seen, caller, allow):
    _set(caller)
    pipe = TwoStagePipeline.initialize(port_config(SMALL), seed=3, device="cpu")
    pipe.allow_tf32 = allow
    assert _flags() == (caller, caller)  # constructing changes nothing
    for name, call in _calls(pipe).items():
        seen.clear()
        call()
        assert _flags() == (caller, caller), name
        if name != "classify":
            assert seen and set(seen) == {(allow, allow)}, name
    # the classifier's forward runs inside the same scope
    with pipe.precision():
        assert _flags() == (allow, allow)
    assert _flags() == (caller, caller)


def test_streaming_runner_calls_run_in_the_scope(seen, tmp_path):
    _set(True)
    pipe = TwoStagePipeline.initialize(port_config(SMALL), seed=3, device="cpu")
    paths = []
    for i, frame in enumerate(peaked_frames(seed=11, batch=3, h=200, w=300)):
        paths.append(str(tmp_path / f"f{i}.jpg"))
        cv2.imwrite(paths[-1], frame)
    out = list(StreamingRunner(pipe, batch_size=2, decode_threads=1,
                               use_native_loader=False).run(paths))
    assert sum(len(p) for p, _ in out) == 3
    assert seen and set(seen) == {(False, False)} and _flags() == (True, True)


def test_bf16_pipeline_runs_under_the_callers_flags(seen):
    for caller in (True, False):
        _set(caller)
        pipe = TwoStagePipeline.initialize(port_config(SMALL), seed=3, dtype=torch.bfloat16,
                                           device="cpu")
        seen.clear()
        pipe.run_fused(peaked_frames(seed=11, batch=1, h=200, w=300))
        assert set(seen) == {(caller, caller)} and _flags() == (caller, caller)


@pytest.mark.parametrize("precision,inside", [(None, False), ("high", True)])
def test_e2e_matmul_precision_reaches_the_rows(seen, tmp_path, precision, inside):
    """The e2e CLI in float32: every detector forward of the run computes
    under ``--matmul_precision``'s TF32 choice; the caller's flags (on here)
    are the same after the run."""
    from litepi_tpu_torch.apps import e2e

    images, labels = tmp_path / "images", tmp_path / "labels"
    images.mkdir()
    labels.mkdir()
    for i in range(2):
        cv2.imwrite(str(images / f"f{i}.jpg"), peaked_frames(seed=30 + i, batch=1, h=96, w=128)[0])
        (labels / f"f{i}.txt").write_text("0 0.5 0.5 0.2 0.2\n")
    _set(True)
    argv = ["--input", str(images), "--labels", str(labels), "--output", str(tmp_path / "out"),
            "--det_input_size", "64", "--batch_size", "2", "--num_classes", "3", "--warmup", "0",
            "--device", "cpu"]
    if precision:
        argv += ["--matmul_precision", precision]
    assert e2e.main(argv) == 0
    assert seen and set(seen) == {(inside, inside)}
    assert _flags() == (True, True)
    assert os.path.exists(tmp_path / "out" / "comparison_summary.csv")
