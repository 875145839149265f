"""The staged programs of the port's TwoStagePipeline (``detect``,
``detect_candidates``, ``classify``) and ``ops/nms.py::nms_fixed`` against
the JAX package's, on the narrow SMALL pipeline in float32 on the CPU.

Tolerances are run_fused's (tests/test_torch_pipeline.py): discrete outputs
exact, scores 1e-6, boxes 1e-3 px, probabilities 1e-5.  The detector input
is the peaked scene letterboxed by the JAX package, and the conf threshold
is the one tests/test_torch_pipeline.py checks to lie in a gap of its
candidate scores.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litepi_tpu.ops.letterbox import letterbox_device as jax_letterbox
from litepi_tpu.ops.nms import nms_fixed as jax_nms_fixed
from litepi_tpu.pipeline import TwoStagePipeline as JaxPipeline
from litepi_tpu_torch.ops.nms import nms_fixed
from litepi_tpu_torch.pipeline import TwoStagePipeline
from litepi_tpu_torch.weights import jax_to_state_dict
from tests.torch_port_helpers import SMALL, jax_init_vars, peaked_frames, port_config

CONF = 0.5000571  # tests/test_torch_pipeline.py


@pytest.fixture(scope="module")
def pipelines():
    det, clf = jax_init_vars(SMALL, seed=0)
    port = TwoStagePipeline.from_jax_vars(port_config(SMALL), det, clf, device="cpu")
    return JaxPipeline(SMALL, det, clf), port


@pytest.fixture(scope="module")
def canvas01():
    canvas = jax_letterbox(peaked_frames(), SMALL.det_input_size, jnp.float32)
    return np.asarray(canvas) / np.float32(255.0)


def test_detect_matches_jax(pipelines, canvas01):
    jp, port = pipelines
    want = {k: np.asarray(v) for k, v in jp.detect(canvas01, CONF).items()}
    got = {k: v.numpy() for k, v in port.detect(canvas01, CONF).items()}
    assert set(got) == set(want) == {"boxes", "scores", "class_ids", "valid"}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["class_ids"], want["class_ids"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-3, rtol=0)
    assert want["valid"].any() and not want["valid"].all()


def _assert_same_candidates(got, want, score_tie=1e-5):
    """Candidates in score order: scores position by position within 1e-6;
    boxes within 1e-3 px and class ids exact, matched one to one inside
    each run of JAX scores closer than ``score_tie`` (float noise between
    the two frameworks may order such near-ties either way)."""
    (gb, gs, gc), (wb, ws, wc) = got, want
    assert gb.shape == wb.shape and gs.shape == ws.shape and gc.shape == wc.shape
    np.testing.assert_allclose(gs, ws, atol=1e-6, rtol=0)
    for b in range(ws.shape[0]):
        cuts = np.flatnonzero(ws[b, :-1] - ws[b, 1:] > score_tie) + 1
        for run in np.split(np.arange(ws.shape[1]), cuts):
            dist = np.abs(gb[b, run][:, None, :] - wb[b, run][None, :, :]).max(-1)
            match = dist.argmin(1)
            assert sorted(match) == list(range(len(run))), "candidates differ"
            assert dist[np.arange(len(run)), match].max() <= 1e-3
            np.testing.assert_array_equal(gc[b, run], wc[b, run][match])


def test_detect_candidates_all_anchors(pipelines, canvas01):
    """``eval_max_candidates`` 0 (SMALL's default) means every anchor:
    20^2 + 10^2 + 5^2 = 525 at 160."""
    jp, port = pipelines
    want = [np.asarray(x) for x in jp.detect_candidates(canvas01)]
    got = [x.numpy() for x in port.detect_candidates(canvas01)]
    assert want[1].shape == (2, 525)
    _assert_same_candidates(got, want)
    got0 = [x.numpy() for x in port.detect_candidates(canvas01, 0)]
    for a, b in zip(got0, got):
        np.testing.assert_array_equal(a, b)


def test_detect_candidates_top_k(pipelines, canvas01):
    """A K whose cut falls in a gap of both frames' scores wider than 4x
    the 1e-6 score tolerance (so the two top-K sets are the same set)."""
    jp, port = pipelines
    full = np.asarray(jp.detect_candidates(canvas01)[1])
    gaps = full[:, :-1] - full[:, 1:]
    k = next(k for k in range(2, 128) if (gaps[:, k - 1] > 4e-6).all())
    want = [np.asarray(x) for x in jp.detect_candidates(canvas01, k)]
    got = [x.numpy() for x in port.detect_candidates(canvas01, k)]
    assert got[0].shape == (2, k, 4)
    _assert_same_candidates(got, want)


@pytest.mark.parametrize("input_color", ["rgb", "bgr"])
def test_classify_matches_jax(input_color):
    det, clf = jax_init_vars(SMALL, seed=0)
    cfg = dataclasses.replace(SMALL, input_color=input_color)
    jp = JaxPipeline(cfg, det, clf)
    port = TwoStagePipeline.from_jax_vars(port_config(cfg), det, clf, device="cpu")
    crops = np.random.default_rng(4).uniform(0, 1, (6, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jp.classify(crops))
    got = port.classify(crops).numpy()
    assert got.shape == (6, SMALL.num_classifier_classes)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _nms_inputs(seed, shape, n_classes=3):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 200, (*shape, 2)).astype(np.float32)
    wh = rng.uniform(4, 80, (*shape, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    # quantised scores: exact ties, broken to the lower index by both
    scores = (rng.integers(0, 40, shape) / 40).astype(np.float32)
    cls = rng.integers(0, n_classes, shape).astype(np.int32)
    return boxes, scores, cls


@pytest.mark.parametrize(
    "shape, budgets",
    [
        ((3, 300), dict(max_candidates=64, max_detections=16)),
        ((2, 40), dict(max_candidates=512, max_detections=64)),  # pads past A
        ((120,), dict(max_candidates=100, max_detections=8)),  # one image
    ],
)
def test_nms_fixed_matches_jax(shape, budgets):
    boxes, scores, cls = _nms_inputs(len(shape) * 10 + shape[-1], shape)
    want = jax_nms_fixed(boxes, scores, cls, 0.3, 0.45, **budgets)
    got = nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores),
                    torch.from_numpy(cls), 0.3, 0.45, **budgets)
    for name, g, w in zip(("boxes", "scores", "class_ids", "valid"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[3].any() and got[3].shape == (*shape[:-1], budgets["max_detections"])


def test_candidate_decoder_not_ported():
    """An injected detector with a candidate decoder and a declared
    capacity, as the JAX pipeline takes them: SMALL's unfolded YoloLitePi
    whose decoder is the DFL decode it would run anyway, capacity 100.
    ``detect_candidates`` clamps K to the capacity (0 and 500 give 100),
    every K reaches the decoder, and the candidates match the JAX
    pipeline's on the same injection."""
    from litepi_tpu.models import YoloLitePi as JaxYolo
    from litepi_tpu.ops.dfl import decode_candidates as jax_decode
    from litepi_tpu_torch.models import YoloLitePi
    from litepi_tpu_torch.ops.dfl import decode_candidates

    det, clf = jax_init_vars(SMALL, seed=0)
    cfg = port_config(SMALL)
    canvas = np.asarray(jax_letterbox(peaked_frames(), SMALL.det_input_size, jnp.float32))
    canvas01 = canvas / np.float32(255.0)
    jp = JaxPipeline(
        SMALL, det, clf, det_model=JaxYolo(SMALL.detector),
        candidate_decoder=lambda out, k: jax_decode(out, jp._anchors, jp._strides, 16, k),
        candidate_capacity=100,
    )
    asked = []

    def decoder(out, k):
        asked.append(k)
        return decode_candidates(out, port._anchors, port._strides, 16, k)

    port = TwoStagePipeline(cfg, jax_to_state_dict(det), jax_to_state_dict(clf), device="cpu",
                            det_model=YoloLitePi(cfg.detector), candidate_decoder=decoder,
                            candidate_capacity=100)
    assert port.det_model.backbone.stem.bn is not None  # injected: BN kept
    for k in (None, 0, 500, 7):
        want = [np.asarray(x) for x in jp.detect_candidates(canvas01, k)]
        got = [x.numpy() for x in port.detect_candidates(canvas01, k)]
        assert got[1].shape == (2, 7 if k == 7 else 100)
        _assert_same_candidates(got, want)
    assert asked == [100, 100, 100, 7]
