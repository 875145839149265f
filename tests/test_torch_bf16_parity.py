"""The port's bfloat16 serving program against the JAX package's bfloat16
program on the same variables: the default pair (yolo_plus's narrow SMALL
detector + ShuffleNetV2) through ``run_fused`` on letterboxed 200x300
frames and on canvas-sized 160x160 frames (the stem kernel's branch, its
plain version here), then the staged ``detect`` and ``classify``.

The bound of each float output is the JAX package's own bf16 drift,
``max |jax_bf16 - jax_f32|`` over the same inputs (valid slots only: an
invalid slot holds whichever sub-threshold candidate came next), with the
float32 parity tolerances of tests/test_torch_pipeline.py as its floor:
scores 1e-6, boxes 1e-3 px, probabilities 1e-5.  The port must lie inside
it: ``max |port_bf16 - jax_bf16| <= bound``.  Discrete outputs (valid, class
ids, labels) must be equal: the conf threshold is the middle of a gap of the
JAX bf16 candidate scores whose half-width exceeds both the JAX drift and
the port's difference of the candidate scores, and every compared label's
top-two probability gap exceeds the port's probability difference (both
checked here).

The port rounds where the JAX bf16 program rounds: its letterbox rounds the
tap weights and the y-stage to bf16 (``ops/letterbox.py::_resize_bf16``),
its dense crop rounds the tap weights and the y-lerps (``round_bf16``, in
the plain crop and the ROI kernel alike), and its stem kernel takes the
bf16 values of the folded weights and bias.  With float32 stem weights the
canvas branch's scores fell outside (1.43e-6 > bound 1e-6); with the
float32 letterbox and crop, a threshold that keeps three letterboxed
detections moved one box as far as JAX's own drift (10.31 px) and the
probabilities beyond it (6.94e-5 > 6.84e-5), and the crop alone differed
from JAX's bf16 crop by exactly JAX's crop drift (0.245 of 255).
Measured margins here (port difference / bound): letterboxed boxes 1.1e-4
/ 1e-3 px, scores 0 / 1e-6, probabilities 1.2e-6 / 1e-5; canvas-sized
boxes 1.0e-4 / 1e-3, scores 4.8e-7 / 1e-6; ``detect`` boxes 7.6e-5 / 1e-3,
scores 4.8e-7 / 1e-6; ``classify`` 2.4e-6 / 5.3e-6.  The letterbox and the
dense crop alone are bit-equal to JAX's in bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litepi_tpu.ops.letterbox import letterbox_device as jax_letterbox
from litepi_tpu.pipeline import TwoStagePipeline as JaxPipeline
from litepi_tpu.weights.fold_bn import fold_stem_input
from litepi_tpu_torch.pipeline import TwoStagePipeline
from tests.torch_port_helpers import (
    SMALL,
    canvas_frames,
    jax_init_vars,
    one_torch_thread,  # noqa: F401 (a fixture, used by pytestmark)
    peaked_frames,
    port_config,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the float32 parity tolerances: the floor of every bound
FLOOR = {"det_scores": 1e-6, "scores": 1e-6, "boxes": 1e-3, "cls_probs": 1e-5,
         "cls_scores": 1e-5}
EXACT = ("valid", "det_class_ids", "class_ids", "cls_labels")


def numpy_out(out):
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in out.items()}


def jax_fused_scores(jp, frames):
    """The candidate scores the JAX ``run_fused`` ranks, sorted per frame."""
    cfg = jp.cfg
    canvas = jax_letterbox(frames, cfg.det_input_size, jp.det_model.dtype)
    if jp._stem_input_foldable:
        raw = fold_stem_input(jp.det_vars, 1.0 / 255.0, cfg.input_color == "bgr")
        return np.asarray(jp._detect_jit(raw, canvas, None, True)[1])
    return np.asarray(jp._detect_jit(jp.det_vars, canvas * (1.0 / 255.0))[1])


def port_fused_scores(port, frames):
    with torch.inference_mode():
        f = torch.as_tensor(frames)
        return port._candidates(port._detect(port._stem(f)))[1].numpy()


def conf_in_gap(bf16, others, min_above=1, max_above=7):
    """(conf, half-gap, drift): the middle of the widest gap of the JAX bf16
    candidate scores with ``min_above``..``max_above`` scores over it in
    every frame, the gap's half-width, and the largest difference between
    the top ``max_above + 1`` sorted scores of ``bf16`` and of each of
    ``others``: the ranks between which the threshold falls, so a drift
    under the half-gap leaves every frame's count over it unchanged."""
    top = max_above + 1
    drift = max(float(np.abs(o[:, :top] - bf16[:, :top]).max()) for o in others)
    flat = np.sort(bf16.ravel())[::-1]
    best = None
    for hi, lo in zip(flat[:-1], flat[1:]):
        conf = (float(hi) + float(lo)) / 2
        above = (bf16 > conf).sum(-1)
        if above.min() >= min_above and above.max() <= max_above:
            if best is None or hi - lo > 2 * best[1]:
                best = (conf, (float(hi) - float(lo)) / 2)
    assert best is not None
    return best[0], best[1], drift


def compare(got, want, ref32, factors=None):
    """Discrete outputs equal; each float output within its bound, or within
    ``factors[name]`` times it (the zoo's deep nets, see
    tests/test_torch_bf16_zoo_parity.py).  Returns {name: (port difference,
    bound)}."""
    v = want["valid"]
    assert v.any() and not v.all(), "the threshold must keep some and drop some"
    margins = {}
    for k in want:
        if k in EXACT:
            np.testing.assert_array_equal(got[k][v] if k != "valid" else got[k],
                                          want[k][v] if k != "valid" else want[k], err_msg=k)
            np.testing.assert_array_equal(ref32[k][v] if k != "valid" else ref32[k],
                                          want[k][v] if k != "valid" else want[k], err_msg=k)
            continue
        assert got[k].shape == want[k].shape, k
        bound = max(float(np.abs(ref32[k] - want[k])[v].max()), FLOOR[k])
        diff = float(np.abs(got[k] - want[k])[v].max())
        factor = (factors or {}).get(k, 1.0)
        assert diff <= factor * bound, (
            f"{k}: port differs from JAX bf16 by {diff} > {factor} x bound {bound}")
        margins[k] = (diff, bound)
    if "cls_probs" in want:
        p = np.sort(want["cls_probs"][v], -1)
        assert (p[:, -1] - p[:, -2]).min() > margins["cls_probs"][0], "labels within the noise"
    return margins


@pytest.fixture(scope="module")
def pipelines():
    det, clf = jax_init_vars(SMALL, seed=0)
    pcfg = port_config(SMALL)
    return (
        JaxPipeline(SMALL, det, clf),
        JaxPipeline(SMALL, det, clf, dtype=jnp.bfloat16),
        TwoStagePipeline.from_jax_vars(pcfg, det, clf, dtype=torch.bfloat16, device="cpu"),
    )


@pytest.mark.parametrize("scene", ["letterboxed_200x300", "canvas_160x160"])
def test_run_fused_bf16_matches_jax_bf16(pipelines, scene, monkeypatch):
    """``run_fused`` port bf16 vs JAX bf16, inside JAX's own bf16 drift; the
    canvas-sized frames go through the stem kernel's branch (its plain
    version), the letterboxed ones through the letterbox and the conv."""
    import litepi_tpu_torch.pipeline.two_stage as port_module

    jf, jb, port = pipelines
    frames = peaked_frames() if scene.startswith("letterboxed") else canvas_frames("rgb")
    sb = jax_fused_scores(jb, frames)
    conf, half_gap, drift = conf_in_gap(sb, [jax_fused_scores(jf, frames),
                                             port_fused_scores(port, frames)])
    assert half_gap > drift, f"gap {2 * half_gap} not wider than the score drift {drift}"

    calls, real = [], port_module.fused_stem
    monkeypatch.setattr(port_module, "fused_stem",
                        lambda *a: calls.append(1) or real(*a))
    got = numpy_out(port.run_fused(frames, conf))
    assert bool(calls) == scene.startswith("canvas")
    want = numpy_out(jb.run_fused(frames, conf))
    ref32 = numpy_out(jf.run_fused(frames, conf))
    compare(got, want, ref32)


def test_detect_bf16_matches_jax_bf16(pipelines):
    """The staged ``detect`` on [0, 1] letterboxed canvases."""
    jf, jb, port = pipelines
    canvas01 = np.asarray(jax_letterbox(peaked_frames(), SMALL.det_input_size,
                                        jnp.float32)) / np.float32(255.0)
    sb = np.asarray(jb._detect_jit(jb.det_vars, canvas01)[1])
    conf, half_gap, drift = conf_in_gap(sb, [np.asarray(jf._detect_jit(jf.det_vars, canvas01)[1]),
                                             port._detect_top(canvas01, 128)[1].numpy()])
    assert half_gap > drift
    got = numpy_out(port.detect(canvas01, conf))
    want = numpy_out(jb.detect(canvas01, conf))
    ref32 = numpy_out(jf.detect(canvas01, conf))
    compare(got, want, ref32)


def test_classify_bf16_matches_jax_bf16(pipelines):
    """``classify`` on seeded [0, 1] crops: probabilities inside the JAX
    drift, argmax equal on every crop whose top two probabilities lie
    further apart than the port's difference (at least 12 of the 16: the
    narrow random-init classifier gives probabilities within 2e-4 of
    0.1)."""
    jf, jb, port = pipelines
    crops = np.random.default_rng(4).uniform(0, 1, (16, 64, 64, 3)).astype(np.float32)
    want, ref32 = np.asarray(jb.classify(crops)), np.asarray(jf.classify(crops))
    got = port.classify(crops).numpy()
    bound = max(float(np.abs(ref32 - want).max()), FLOOR["cls_probs"])
    diff = float(np.abs(got - want).max())
    assert diff <= bound
    p = np.sort(want, -1)
    clear = (p[:, -1] - p[:, -2]) > diff
    assert clear.sum() >= 12
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


@pytest.mark.parametrize("hw", [(200, 300), (300, 200), (100, 150), (45, 640)])
def test_bf16_letterbox_bit_equal_to_jax(hw):
    """The bf16 letterbox (down, up, portrait, landscape, one side already
    at size) equals the JAX package's bf16 ``letterbox_device`` bit for
    bit."""
    from litepi_tpu_torch.ops.letterbox import letterbox_device

    frames = np.random.default_rng(hw[0]).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    want = np.asarray(jax_letterbox(frames, 160, jnp.bfloat16)).astype(np.float32)
    got = letterbox_device(torch.from_numpy(frames), 160, torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_bf16_dense_crop_bit_equal_to_jax():
    """The dense crop with ``compute_dtype=torch.bfloat16`` (the plain
    version of the ROI kernel's ``round_bf16`` mode) equals the JAX bf16
    dense crop bit for bit, on boxes of every size class (sub-pixel,
    small, frame-wide, at the borders); in float32 it differs by JAX's own
    bf16 crop drift."""
    from litepi_tpu.ops.roi import crop_and_resize as jax_crop
    from litepi_tpu_torch.ops.roi import crop_and_resize

    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (2, 120, 200, 3), dtype=np.uint8)
    xy = rng.uniform(-5, 190, (2, 12, 2))
    wh = rng.choice([0.4, 3.0, 17.5, 64.0, 250.0], (2, 12, 2)) * rng.uniform(0.8, 1.2, (2, 12, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = rng.uniform(size=(2, 12)) < 0.8
    want = np.asarray(jax_crop(frames, boxes, valid, 64, jnp.bfloat16, 1))
    t = (torch.from_numpy(frames), torch.from_numpy(boxes), torch.from_numpy(valid), 64)
    got = crop_and_resize(*t, compute_dtype=torch.bfloat16).numpy()
    np.testing.assert_array_equal(got, want)
    f32 = crop_and_resize(*t).numpy()
    assert 0 < np.abs(f32 - want).max() <= 1.0
