"""The harness at a large class vocabulary: the calibration quantile past
``torch.quantile``'s 2^24 values, ``make_states`` and the reference against
``run_fused`` for a detector of 1,203 classes, the judge's class-aware
decision checks on hand-made blocks, and LayerNorm drawn as a norm.  With
one class the judge and the draws are what they were: the frozen
class-blind checks and leaf kinds below are the parent's, kept to compare
with."""

import json

import numpy as np
import pytest
import torch
from torch import nn

from cardbench import judge, program, spec, traffic, weights
from cardbench.judge import INF, MATCH_PX, MATCH_SCORE, logit
from cardbench.reference.two_stage import Reference, box_iou, build_model

VOCAB = 1203  # LVIS's categories
SERVING = {"conf_threshold": 0.25, "iou_threshold": 0.45, "max_candidates": 64}


def bits(t: torch.Tensor) -> int:
    return int(t.reshape(()).view(torch.int32))


def definition(x: torch.Tensor, q: float) -> float:
    """Linear interpolation between the order statistics at floor and ceil
    of q (n - 1), in float64, rounded once to float32."""
    v = x.double().numpy()
    rank = q * (v.size - 1)
    lo, hi = int(np.floor(rank)), int(np.ceil(rank))
    part = np.partition(v, [lo, hi])
    value = part[lo] + (rank - lo) * (part[hi] - part[lo])
    return float(np.float32(value))


# ------------------------------------------------------------------ #
# (i) the quantile                                                   #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("n", [1, 2, 3, 7, 100, 4097, (1 << 20) + 3])
def test_forced_quantile_equals_torch_bit_for_bit(n):
    gen = torch.Generator().manual_seed(n)
    x = torch.randn(n, generator=gen) * 1.5 - 0.3
    x[: n // 3] = x[n // 3: 2 * (n // 3)]  # ties
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0, 0.123456):
        assert bits(weights.quantile(x, q, limit=0)) == bits(torch.quantile(x, q)), (n, q)


def test_forced_quantile_equals_torch_at_its_limit():
    x = torch.randn(1 << 24, generator=torch.Generator().manual_seed(7))
    assert bits(weights.quantile(x, 0.99, limit=0)) == bits(torch.quantile(x, 0.99))


@pytest.mark.parametrize("n", [(1 << 24) + 1, int(2.1 * (1 << 24))])
def test_quantile_past_the_limit_is_the_definition(n):
    x = torch.randn(n, generator=torch.Generator().manual_seed(n))
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(x, 0.99)
    got = weights.quantile(x, 0.99)
    assert got.dtype == torch.float32 and float(got) == definition(x, 0.99)


def test_quantile_is_nan_with_a_nan_and_takes_only_float32():
    x = torch.randn(1000)
    x[17] = float("nan")
    assert torch.isnan(weights.quantile(x, 0.5, limit=0))
    with pytest.raises(TypeError):
        weights.quantile(torch.randn(10, dtype=torch.float64), 0.5, limit=0)


def test_order_statistic_of_infinities_and_signed_values():
    x = torch.tensor([3.0, -float("inf"), -2.5, 0.0, float("inf"), -1e-40, 7.0, -2.5])
    want = torch.sort(x).values
    for k in range(x.numel()):
        assert weights.order_statistic(x, k) == float(want[k])


# ------------------------------------------------------------------ #
# (ii) make_states past the limit, (iii) reference vs run_fused       #
# ------------------------------------------------------------------ #

def vocab_config(dtype="float32", size=448):
    cfg = spec.resolve("yolo11n-resnet18.card-b256").config
    return dict(cfg, detector=dict(cfg["detector"], num_classes=VOCAB, input_size=size),
                serving=dict(cfg["serving"], dtype=dtype))


@pytest.fixture(scope="module")
def vocab_states():
    """YOLO11n at 448 with 1,203 classes: 4 x 4,116 x 1,203 = 19.8 M
    calibration logits; every call of the quantile recorded."""
    calls = []
    real = weights.quantile

    def recording(values, q, limit=weights.TORCH_QUANTILE_MAX):
        out = real(values, q, limit)
        calls.append((values.clone(), q, out))
        return out

    weights.quantile = recording
    try:
        cfg = vocab_config()
        det, cls = weights.make_states(cfg, 2**31 + 99, "cpu")
    finally:
        weights.quantile = real
    return cfg, det, cls, calls


def test_make_states_calibrates_past_the_quantile_limit(vocab_states):
    cfg, det, _, calls = vocab_states
    (values, q, shift), = calls
    assert values.numel() == 4 * 4116 * VOCAB > weights.TORCH_QUANTILE_MAX
    assert float(shift) == definition(values, q)
    # the shifted head puts about POSITIVE_SHARE of the calibration logits above 0
    s = cfg["detector"]["input_size"]
    frames = traffic.make_frames(2**31 + 99, weights.CALIBRATION_FIRST, weights.CALIBRATION_FRAMES,
                                 s, s, "cpu")
    x = (frames.permute(0, 3, 1, 2).float() / 255.0).flip(1)
    model = build_model(cfg["detector"]).eval()
    model.load_state_dict(det)
    with torch.no_grad():
        share = float((model(x)["cls"] > 0).float().mean())
    assert share == pytest.approx(weights.POSITIVE_SHARE, rel=0.05)


def test_centring_spreads_the_best_class_over_anchors(vocab_states):
    cfg, det, cls, _ = vocab_states
    ref = Reference(cfg, det, cls, "cpu")
    got = ref.detect_all(traffic.make_frames(6, 0, 2, 448, 448, "cpu"))
    top = got["scores"].topk(64, dim=-1).indices
    for f in range(2):
        assert len(set(got["class_ids"][f, top[f]].tolist())) >= 4
    assert len(set(got["class_ids"].flatten().tolist())) > VOCAB // 4


def parent_detector_calibration(config: dict, seed: int, device):
    """make_states' detector before the class centring (frozen)."""
    det_spec = config["detector"]
    det = weights.raw_state(det_spec, seed, device, 1, weights.BN_BIAS_STD)
    s = det_spec["input_size"]
    frames = traffic.make_frames(seed, weights.CALIBRATION_FIRST, weights.CALIBRATION_FRAMES,
                                 s, s, device)
    x = frames.permute(0, 3, 1, 2).float() * (1.0 / 255.0)
    if config["serving"]["input_color"] == "bgr":
        x = x.flip(1)
    det, head = weights.calibrate_batchnorm(build_model(det_spec), det, x, device)
    weights._scale(det, weights.head_keys(det_spec, "reg"),
                   weights.REG_LOGIT_STD / float(head["reg"].std()))
    cls_factor = weights.CLS_LOGIT_STD / float(head["cls"].std())
    weights._scale(det, weights.head_keys(det_spec, "cls"), cls_factor)
    shift = torch.quantile(head["cls"].float().flatten() * cls_factor,
                           1.0 - weights.POSITIVE_SHARE)
    for k in weights.head_keys(det_spec, "cls"):
        if k.endswith(".bias"):
            det[k] = det[k] - shift
    return det


@pytest.mark.parametrize("cell", ["litepi-v2.card-b256", "yolo11n-resnet18.card-b256"])
def test_one_class_detectors_calibrate_bit_for_bit_as_before(cell):
    cfg = spec.resolve(cell).config
    det, _ = weights.make_states(cfg, 2**31 + 5, "cpu")
    old = parent_detector_calibration(cfg, 2**31 + 5, "cpu")
    assert list(det) == list(old)
    for k in det:
        assert det[k].dtype == old[k].dtype and torch.equal(
            det[k].reshape(-1).view(torch.uint8), old[k].reshape(-1).view(torch.uint8)), k


def test_reference_matches_run_fused_at_1203_classes(vocab_states):
    cfg, det, cls, _ = vocab_states
    frames = traffic.make_frames(5, 0, 2, 448, 448, "cpu")
    got = program.build(cfg, det, cls, 2, "cpu")(frames)
    ref = Reference(cfg, det, cls, "cpu")
    want = ref.run_pipeline(frames)
    v = want["valid"]
    assert torch.equal(got["valid"], v) and int(v.sum()) >= 4
    kept = got["det_scores"] > cfg["serving"]["conf_threshold"]
    assert torch.equal(kept, want["det_scores"] > cfg["serving"]["conf_threshold"])
    assert torch.equal(got["det_class_ids"][kept], want["det_class_ids"][kept])
    assert len(set(want["det_class_ids"][kept].tolist())) > 1
    assert torch.allclose(got["boxes"][kept], want["boxes"][kept], atol=2e-2)
    assert torch.allclose(got["det_scores"], want["det_scores"], atol=1e-4)
    assert torch.allclose(got["cls_probs"][v], want["cls_probs"][v], atol=1e-4)
    assert torch.equal(got["cls_labels"][v], want["cls_labels"][v])
    # the class-aware NMS kept overlapping boxes of different classes that a
    # class-blind NMS would have suppressed (canvas-sized frames: frame
    # boxes are canvas boxes)
    over = box_iou(want["boxes"], want["boxes"]) > cfg["serving"]["iou_threshold"]
    cid = want["det_class_ids"]
    assert bool((over & kept[:, :, None] & kept[:, None, :] & (cid[:, :, None] != cid[:, None, :])).any())
    numbers = judge.gaps(ref, [(frames, got)])
    assert numbers["box"] < 0.05 and numbers["score"] < 1e-4
    assert numbers["choice"] < 1e-3 and numbers["prob"] < 1e-3


# ------------------------------------------------------------------ #
# (iv) the judge's class-aware checks on hand-made blocks             #
# ------------------------------------------------------------------ #

def block(logits, boxes, kept, ids):
    """One frame: the reference's anchors with class ``logits`` (A, nc) and
    canvas ``boxes`` (A, 4) (canvas-sized: frame boxes are the same); the
    program's slots keep anchors ``kept`` with class ``ids``, at the
    reference's own boxes and scores."""
    logits = torch.tensor(logits, dtype=torch.float32)[None]
    boxes = torch.tensor(boxes, dtype=torch.float32)[None]
    scores, class_ids = torch.sigmoid(logits).max(-1)
    det = {"scores": scores, "class_ids": class_ids, "cls_logits": logits,
           "boxes_lb": boxes, "boxes": boxes}
    d = 4
    prog = {"boxes": torch.zeros(1, d, 4), "det_scores": torch.zeros(1, d),
            "det_class_ids": torch.full((1, d), -1, dtype=torch.int32)}
    for j, (a, c) in enumerate(zip(kept, ids)):
        prog["boxes"][0, j] = boxes[0, a]
        prog["det_scores"][0, j] = scores[0, a]
        prog["det_class_ids"][0, j] = c
    return det, prog


def violation(det, prog, checks=None):
    return float((checks or judge._frame_checks)(det, prog, SERVING, 1.0)["viol"][0])


# two boxes at IoU 0.8, two far apart below the threshold
BOXES = [[0, 0, 100, 100], [0, 0, 100, 80], [300, 300, 340, 340], [400, 400, 440, 440]]
LOW = [-5.0, -5.0, -5.0]


def test_overlapping_kept_slots_of_different_classes_are_no_violation():
    # anchors 0 and 1 tie classes 0 and 1, so either id reads a class gap of 0
    det, prog = block([[3.0, 3.0, -5.0], [2.0, 2.0, -5.0], LOW, LOW], BOXES, [0, 1], [0, 1])
    assert violation(det, prog) == 0.0
    det, prog = block([[3.0, 3.0, -5.0], [2.0, 2.0, -5.0], LOW, LOW], BOXES, [0, 1], [0, 0])
    # one class: the smaller of the overlap's excess and the logit gap
    assert violation(det, prog) == pytest.approx(0.8 - 0.45, abs=1e-6)


def test_a_kept_box_of_another_class_explains_no_left_out_candidate():
    # anchor 1's best class is 1, 5 logits above class 0; the program kept
    # only anchor 0, of class 0, and left anchor 1 out
    det, prog = block([[3.0, -5.0, -5.0], [-3.0, 2.0, -5.0], LOW, LOW], BOXES, [0], [0])
    assert violation(det, prog) == pytest.approx(2.0 - float(logit(torch.tensor(0.25))), rel=1e-6)
    # of its own class, the kept box explains it
    det, prog = block([[3.0, -5.0, -5.0], [1.99, 2.0, -5.0], LOW, LOW], BOXES, [0], [1])
    assert violation(det, prog) == pytest.approx(3.0 - (-5.0), rel=1e-6)  # slot 0's class gap
    det, prog = block([[-5.0, 3.0, -5.0], [-3.0, 2.0, -5.0], LOW, LOW], BOXES, [0], [1])
    assert violation(det, prog) == 0.0
    # another class whose logit nearly ties the candidate's best explains it at that gap
    det, prog = block([[3.0, -5.0, -5.0], [1.99, 2.0, -5.0], LOW, LOW], BOXES, [0], [0])
    assert violation(det, prog) == pytest.approx(0.01, abs=1e-6)


def test_a_flipped_class_id_reads_the_references_logit_gap():
    logits = [[3.0, -5.0, -5.0], LOW, [-3.0, 2.0, 0.5], LOW]
    for c, gap in ((1, 0.0), (2, 1.5), (0, 5.0)):
        det, prog = block(logits, BOXES, [0, 2], [0, c])
        assert violation(det, prog) == pytest.approx(gap, abs=1e-6)


@pytest.mark.parametrize("c", [-1, 3, 1203])
def test_a_class_id_outside_the_classes_is_infinitely_far(c):
    det, prog = block([[3.0, -5.0, -5.0], LOW, [-3.0, 2.0, 0.5], LOW], BOXES, [0, 2], [0, c])
    assert violation(det, prog) == INF


def class_blind_checks(det: dict, prog: dict, sv: dict, ratio: float) -> dict:
    """The judge's decision checks before they took classes (frozen)."""
    conf, thr, kcap = sv["conf_threshold"], sv["iou_threshold"], sv["max_candidates"]
    boxes, scores = prog["boxes"], prog["det_scores"]
    nmsv = scores > conf
    n, d = scores.shape
    dist = (boxes[:, :, None, :] - det["boxes"][:, None, :, :]).abs().amax(-1)  # (n, D, A)
    cost = torch.maximum(dist * (ratio / MATCH_PX),
                         (scores[:, :, None] - det["scores"][:, None, :]).abs() / MATCH_SCORE)
    a_star = cost.argmin(-1)
    box_gap = torch.gather(dist, 2, a_star[..., None])[..., 0]
    s_star = torch.gather(det["scores"], 1, a_star)
    lb_star = torch.gather(det["boxes_lb"], 1, a_star[..., None].expand(-1, -1, 4))
    viol = torch.zeros(n, device=scores.device)

    def worst(v, mask):
        return torch.where(mask, v, 0.0).reshape(n, -1).amax(-1)

    cls_star = torch.gather(det["class_ids"], 1, a_star)
    viol = torch.maximum(viol, worst((cls_star != prog["det_class_ids"]).float(), nmsv))
    s_sorted, i_sorted = torch.sort(det["scores"], dim=-1, descending=True, stable=True)
    l_sorted, l_star, l_conf = logit(s_sorted), logit(s_star), float(logit(torch.tensor(conf)))
    a = s_sorted.shape[1]
    k = min(kcap, a)
    l_next = l_sorted[:, k] if a > k else torch.full((n,), -INF, device=scores.device)
    viol = torch.maximum(viol, worst(torch.clamp(l_conf - l_star, min=0.0), nmsv))
    viol = torch.maximum(viol, worst(torch.clamp(l_sorted[:, k - 1:k] - l_star, min=0.0), nmsv))
    pair_iou = box_iou(lb_star, lb_star)
    pair = nmsv[:, :, None] & nmsv[:, None, :] & ~torch.eye(d, dtype=torch.bool, device=scores.device)
    overlap = torch.minimum(pair_iou - thr, (l_star[:, :, None] - l_star[:, None, :]).abs())
    viol = torch.maximum(viol, worst(torch.clamp(overlap, min=0.0), pair))
    cand, l_c, s_c = i_sorted[:, :k], l_sorted[:, :k], s_sorted[:, :k]
    lb_c = torch.gather(det["boxes_lb"], 1, cand[..., None].expand(-1, -1, 4))
    in_k = ((cand[:, :, None] == a_star[:, None, :]) & nmsv[:, None, :]).any(-1)
    full = nmsv.sum(-1) >= d
    min_kept = torch.where(nmsv, l_star, INF).amin(-1)
    e_conf = l_c - l_conf
    e_full = torch.where(full[:, None], torch.clamp(l_c - min_kept[:, None], min=0.0), INF)
    e_cut = l_c - l_next[:, None]
    by_kept = torch.maximum(torch.clamp(l_c[:, :, None] - l_star[:, None, :], min=0.0),
                            torch.clamp(thr - box_iou(lb_c, lb_star), min=0.0))
    e_supp = torch.where(nmsv[:, None, :], by_kept, INF).amin(-1)
    missed = torch.minimum(torch.minimum(e_conf, e_full), torch.minimum(e_cut, e_supp))
    viol = torch.maximum(viol, worst(torch.clamp(missed, min=0.0), ~in_k & (s_c > conf)))
    return {"nmsv": nmsv, "box_gap": box_gap, "score_gap": (logit(scores) - l_star).abs(),
            "l_star": l_star, "viol": viol}


@pytest.mark.parametrize("seed", range(6))
def test_one_class_checks_read_as_the_class_blind_ones(seed):
    """Random one-class blocks: dense overlapping anchors, slots that keep,
    drop, shift and rescore anchors, some full frames; every output equal."""
    g = torch.Generator().manual_seed(seed)
    n, a, d = 8, 300, 16
    xy = torch.rand(n, a, 2, generator=g) * 200
    wh = 5 + torch.rand(n, a, 2, generator=g) * 60
    lb = torch.cat([xy, xy + wh], -1)
    logits = torch.randn(n, a, 1, generator=g) * 2
    scores = torch.sigmoid(logits[..., 0])
    det = {"scores": scores, "class_ids": torch.zeros(n, a, dtype=torch.long),
           "cls_logits": logits, "boxes_lb": lb, "boxes": lb}
    pick = torch.argsort(torch.rand(n, a, generator=g), -1)[:, :d]
    noise = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    boxes = torch.gather(lb, 1, pick[..., None].expand(-1, -1, 4)) + noise(n, d, 4) * 2
    sc = torch.gather(scores, 1, pick) + noise(n, d) * 0.01
    sc = torch.where(torch.rand(n, d, generator=g) < 0.3, 0.0, sc.clamp(0, 1))
    sc[0] = 0.9 + 0.05 * torch.rand(d, generator=g)  # a full frame
    prog = {"boxes": boxes, "det_scores": sc,
            "det_class_ids": torch.where(sc > 0.25, 0, -1).int()}
    for sv in (SERVING, dict(SERVING, max_candidates=500)):
        new = judge._frame_checks(det, prog, sv, 1.0)
        old = class_blind_checks(det, prog, sv, 1.0)
        assert float(old["viol"].max()) > 0.1
        for k in old:
            assert torch.equal(new[k], old[k]), k


# ------------------------------------------------------------------ #
# LayerNorm drawn as a norm                                           #
# ------------------------------------------------------------------ #

def parent_kind(model: nn.Module, key: str):
    """The leaf kinds before LayerNorm had its own (frozen)."""
    mod_name, _, leaf = key.rpartition(".")
    mod = model.get_submodule(mod_name)
    if isinstance(mod, nn.BatchNorm2d):
        return {"weight": "bn_weight", "bias": "bn_bias"}.get(leaf, leaf)
    return "weight" if leaf == "weight" else "bias"


class PooledAttentionToy(nn.Module):
    """A conv, its BatchNorm, and the LayerNorms and projections of an
    image-pooling attention (YOLO-World's ``ImagePoolingAttn`` holds three)."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 16, 3)
        self.bn = nn.BatchNorm2d(16)
        self.query = nn.Sequential(nn.LayerNorm(512), nn.Linear(512, 256))
        self.key = nn.Sequential(nn.LayerNorm(256), nn.Linear(256, 256))
        self.value = nn.Sequential(nn.LayerNorm(256), nn.Linear(256, 256))


def test_layernorm_gains_and_shifts_are_drawn_as_norms(monkeypatch):
    monkeypatch.setattr(weights, "build_model", lambda spec: PooledAttentionToy())
    state = weights.raw_state({}, 2**31 + 7, "cpu", 1, weights.BN_BIAS_STD)
    for name in ("query.0", "key.0", "value.0"):
        w, b = state[f"{name}.weight"], state[f"{name}.bias"]
        assert float(w.min()) >= 0.5 and float(w.max()) <= 1.5 and float(w.std()) > 0.25
        assert float(b.abs().max()) < 0.6 and 0.08 < float(b.std()) < 0.12
    # linear layers keep lecun normal
    assert 0.03 < float(state["query.1.weight"].std()) < 0.06


@pytest.mark.parametrize("config", ["litepi-v2-shufflenetv2", "yolo11n-resnet18",
                                    "yolo12l-shufflenetv2"])
def test_accepted_configurations_draw_the_same_states(config, monkeypatch):
    cfg = json.loads((spec.HERE / "configs" / f"{config}.json").read_text())
    for salt, part in ((1, "detector"), (2, "classifier")):
        new = weights.raw_state(cfg[part], 2**31 + 11, "cpu", salt, weights.BN_BIAS_STD)
        with monkeypatch.context() as m:
            m.setattr(weights, "_kind", parent_kind)
            old = weights.raw_state(cfg[part], 2**31 + 11, "cpu", salt, weights.BN_BIAS_STD)
        assert list(new) == list(old)
        assert all(torch.equal(new[k], old[k]) for k in new)
