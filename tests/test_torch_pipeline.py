"""The slice as a whole: the port's TwoStagePipeline.run_fused vs the JAX
package's on the same weights and frames (litepi_tpu_torch/pipeline).

Both run tests/test_pipeline.py's narrow SMALL pipeline in float32 on the
CPU, where the port runs its kernels' plain versions and the JAX side its
XLA paths (the Pallas crop in interpret mode).  The frames are the peaked
scene of tests/test_pipeline.py, and the confidence threshold sits in a
gap of the candidate scores (checked below), so that float noise between
XLA's and oneDNN's convolutions cannot flip a discrete decision.

Tolerances: discrete outputs (valid, class ids, labels) exact; scores
1e-6 (sigmoid ulps at 0.5); boxes 1e-3 px (head-logit noise through the
DFL expectation, x stride / ratio); classifier probabilities 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litepi_tpu.ops.boxes import box_area as jax_box_area
from litepi_tpu.ops.boxes import clip_boxes as jax_clip
from litepi_tpu.ops.dfl import decode_candidates as jax_decode
from litepi_tpu.ops.letterbox import letterbox_device as jax_letterbox
from litepi_tpu.ops.letterbox import letterbox_params
from litepi_tpu.ops.nms import nms_sorted as jax_nms
from litepi_tpu.ops.roi import crop_and_resize as jax_crop
from litepi_tpu.pipeline import TwoStagePipeline as JaxPipeline
from litepi_tpu_torch.ops.dfl import topk_stable
from litepi_tpu_torch.pipeline import TwoStagePipeline
from tests.torch_port_helpers import (
    CANVAS_SCENES,
    SMALL,
    canvas_frames,
    jax_init_vars,
    peaked_frames,
    port_config,
)

# the middle of a 4.5e-6 gap in the peaked scene's candidate scores:
# 18 / 16 candidates clear it and NMS keeps 2 per frame
CONF = 0.5000571

EXACT = ("valid", "det_class_ids", "cls_labels")
CLOSE = {"det_scores": 1e-6, "boxes": 1e-3, "cls_probs": 1e-5, "cls_scores": 1e-5}


@pytest.fixture(scope="module")
def variables():
    return jax_init_vars(SMALL, seed=0)


@pytest.fixture(scope="module")
def frames():
    return peaked_frames()


def test_conf_threshold_clears_candidate_scores(variables, frames):
    """Fixture check: no candidate score lies within 1e-6 of CONF."""
    det, clf = variables
    jp = JaxPipeline(SMALL, det, clf)
    canvas = jax_letterbox(frames, SMALL.det_input_size, jnp.float32) / 255.0
    _, scores, _ = jp._detect_jit(jp.det_vars, canvas)
    scores = np.asarray(scores)
    assert np.abs(scores - CONF).min() > 1e-6
    assert ((scores > CONF).sum(-1) > 8).all()


def _compare(got, want):
    assert set(got) == set(want)
    for k in EXACT:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, tol in CLOSE.items():
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0, err_msg=k)


VARIANTS = {
    "unbudgeted": {},
    # the serving budgets' proportions (bench.py: crop_det_budget 8 of 16
    # detections, cls_crop_budget 4*B of 8*B slots) with BGR host frames
    "serving_budgets": dict(crop_det_budget=4, cls_crop_budget=4, input_color="bgr"),
    # a budget above the valid count: invalid slots tie at -1 and the
    # lowest-index ones are classified (changes cls_probs there)
    "tied_budget": dict(cls_crop_budget=11),
    "pallas_crop": dict(roi_impl="pallas"),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_run_fused_matches_jax(variables, frames, variant):
    det, clf = variables
    cfg = dataclasses.replace(SMALL, **VARIANTS[variant])
    area_scale = np.array([1.0, 1e-5], np.float32) if variant == "pallas_crop" else None
    want = JaxPipeline(cfg, det, clf).run_fused(frames, CONF, area_scale)
    want = {k: np.asarray(v) for k, v in want.items()}
    port = TwoStagePipeline.from_jax_vars(port_config(cfg), det, clf, device="cpu")
    got = {k: v.numpy() for k, v in port.run_fused(frames, CONF, area_scale).items()}
    _compare(got, want)
    v = want["valid"]
    assert v.any() and not v.all()
    if variant == "tied_budget":
        assert v.sum() < cfg.cls_crop_budget
    if variant == "pallas_crop":  # area_scale 1e-5 drops frame 1's boxes
        assert v[0].any() and not v[1].any()


@pytest.mark.parametrize("input_color", ["rgb", "bgr"])
def test_canvas_conf_threshold_clears_candidate_scores(variables, input_color):
    """Fixture check for the canvas-sized frames: no candidate score lies
    within 1e-6 of the scene's conf threshold, and at least 12 clear it per
    frame."""
    det, clf = variables
    conf = CANVAS_SCENES[input_color][1]
    jp = JaxPipeline(dataclasses.replace(SMALL, input_color=input_color), det, clf)
    canvas = jnp.asarray(canvas_frames(input_color), jnp.float32) / 255.0
    _, scores, _ = jp._detect_jit(jp.det_vars, canvas)
    scores = np.asarray(scores)
    assert np.abs(scores - conf).min() > 1e-6
    assert ((scores > conf).sum(-1) >= 12).all()


@pytest.mark.parametrize("input_color", ["rgb", "bgr"])
def test_run_fused_on_canvas_sized_frames_matches_jax(variables, monkeypatch, input_color):
    """Frames at the detector's input size (160x160 for SMALL) take the
    stem-kernel branch: fused_stem on the uint8 frames, no letterbox.  The
    outputs match the JAX run_fused (letterbox identity + XLA stem) within
    the run_fused tolerances."""
    import litepi_tpu_torch.pipeline.two_stage as port_module

    det, clf = variables
    frames, conf = canvas_frames(input_color), CANVAS_SCENES[input_color][1]
    cfg = dataclasses.replace(SMALL, input_color=input_color)
    want = JaxPipeline(cfg, det, clf).run_fused(frames, conf)
    want = {k: np.asarray(v) for k, v in want.items()}
    port = TwoStagePipeline.from_jax_vars(port_config(cfg), det, clf, device="cpu")
    calls, real = [], port_module.fused_stem

    def spy(stem_frames, *rest):
        calls.append(tuple(stem_frames.shape))
        return real(stem_frames, *rest)

    monkeypatch.setattr(port_module, "fused_stem", spy)
    got = {k: v.numpy() for k, v in port.run_fused(frames, conf).items()}
    assert calls == [frames.shape]
    _compare(got, want)
    v = want["valid"]
    assert v.any() and not v.all()


def _planted_head(det_out, seed=0):
    """The JAX detector's head output with its class logits replaced by a
    coarse grid (exact ties) plus a few strong peaks, so that the discrete
    decisions downstream are clear."""
    rng = np.random.default_rng(seed)
    reg = np.array(det_out["reg"])
    cls = rng.integers(-16, -8, np.asarray(det_out["cls"]).shape).astype(np.float32) * 0.25
    for b in range(cls.shape[0]):
        peaks = rng.choice(cls.shape[1], 12, replace=False)
        cls[b, peaks, 0] = rng.integers(0, 12, 12) * 0.25
    return {"reg": reg, "cls": cls}


def test_stages_on_the_same_head_output(variables, frames):
    """decode -> NMS -> unletterbox/area -> crop -> classify, port vs JAX,
    fed the same head output: the candidate indices, the NMS decisions and
    the valid mask are bit-equal; floats within the stated tolerances."""
    det, clf = variables
    cfg = SMALL
    jp = JaxPipeline(cfg, det, clf)
    port = TwoStagePipeline.from_jax_vars(port_config(cfg), det, clf, device="cpu")
    canvas = jax_letterbox(frames, cfg.det_input_size, jnp.float32) / 255.0
    head = _planted_head(jp.det_model.apply(jp.det_vars, canvas, train=False))
    thead = {k: torch.from_numpy(v) for k, v in head.items()}
    k, d = cfg.nms.max_candidates, cfg.nms.max_detections

    jb, js, jc = jax_decode(
        {k_: jnp.asarray(v) for k_, v in head.items()},
        jp._anchors, jp._strides, 16, k, "exact",
    )
    tb, ts, tc = port._candidates(thead)
    _, jidx = jax.lax.top_k(np.asarray(jax.nn.sigmoid(head["cls"])).max(-1), k)
    _, tidx = topk_stable(torch.sigmoid(thead["cls"]).amax(-1), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-4, rtol=0)

    # NMS on the same candidates (the JAX ones) -> bit-equal decisions
    conf = 0.5
    want = jax_nms(jb, js, jc, conf, cfg.nms.iou_threshold, d, use_pallas=False)
    got = port._suppress(
        torch.tensor(np.asarray(jb)), torch.tensor(np.asarray(js)),
        torch.tensor(np.asarray(jc)), conf,
    )
    for name, g, w in zip(("boxes", "scores", "class_ids", "valid"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    nb, _, _, nv = (np.array(x) for x in want)
    assert nv.any() and not nv.all()

    # unletterbox, clip and the min-area floor
    h, w = frames.shape[1:3]
    ratio, dw, dh, _, _ = letterbox_params(h, w, cfg.det_input_size)
    shift = np.array([dw, dh, dw, dh], np.float32)
    j_orig = jax_clip((jnp.asarray(nb) - shift) / ratio, w, h)
    t_orig, t_valid = port._unmap(torch.from_numpy(nb), torch.from_numpy(nv), h, w)
    np.testing.assert_array_equal(t_orig.numpy(), np.asarray(j_orig))
    np.testing.assert_array_equal(
        t_valid.numpy(), nv & np.asarray(jax_box_area(j_orig) >= cfg.nms.min_area)
    )

    # crop (dense) and classify the same boxes
    j_crops = np.asarray(jax_crop(frames, j_orig, nv, 64, jnp.float32, 8)) / 255.0
    t_crops = port._crop(torch.from_numpy(frames), t_orig, torch.from_numpy(nv))
    np.testing.assert_allclose(t_crops.numpy(), j_crops, atol=1e-5, rtol=0)
    flat = j_crops.reshape(-1, 64, 64, 3).astype(np.float32)
    want_p = np.asarray(jp.classify(flat))
    with torch.inference_mode():
        got_p = port._classify(torch.from_numpy(flat)).numpy()
    np.testing.assert_allclose(got_p, want_p, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_p.argmax(-1), want_p.argmax(-1))


def test_windowed_roi_impl_not_ported(variables, frames):
    """``roi_impl="windowed"`` is ported now (the name is the test's
    history): run_fused with the windowed crop on the 200x300 frames,
    larger than its 128 window, matches the JAX package's within the
    run_fused tolerances."""
    det, clf = variables
    cfg = dataclasses.replace(SMALL, roi_impl="windowed")
    want = {k: np.asarray(v) for k, v in JaxPipeline(cfg, det, clf).run_fused(frames, CONF).items()}
    port = TwoStagePipeline.from_jax_vars(port_config(cfg), det, clf, device="cpu")
    got = {k: v.numpy() for k, v in port.run_fused(frames, CONF).items()}
    _compare(got, want)
    assert want["valid"].any()


def test_bfloat16_pipeline_runs(variables, frames):
    """bf16 weights and activations, f32 decode and softmax: the contract's
    shapes, dtypes and finiteness.  The values are held against the JAX
    package's bf16 program in tests/test_torch_bf16_parity.py."""
    det, clf = variables
    port = TwoStagePipeline.from_jax_vars(
        port_config(SMALL), det, clf, dtype=torch.bfloat16, device="cpu"
    )
    out = port.run_fused(frames, CONF)
    assert out["boxes"].dtype == torch.float32
    assert out["cls_probs"].dtype == torch.float32
    assert out["det_class_ids"].dtype == torch.int32
    for v in out.values():
        assert torch.isfinite(v.double()).all()
    torch.testing.assert_close(
        out["cls_probs"].sum(-1), torch.ones(out["valid"].shape), atol=1e-4, rtol=0
    )
