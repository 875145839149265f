"""The comparison that decides ``correct``: the program's ``run_fused``
outputs for frames of the timed window, held against the float32 plain
reference (``cardbench/reference/two_stage.py``).

A bf16 program and a float32 reference rank near-equal candidates
differently, so the discrete outputs are judged by how far the reference's
own values would have to move to explain them, never by equality.  Each
of the program's detection slots (score above the confidence threshold) is
matched to the reference anchor nearest in box and score together
(:data:`MATCH_PX`, :data:`MATCH_SCORE`).  Six numbers:

``box``
    the median over the judged slots of the matched box's distance
    (largest coordinate gap, frame pixels);
``score``
    the median over the judged slots of the gap between the matched
    detection scores' logits (scores near 0 and 1 compress their gaps,
    logits do not);
``choice``
    the median over the judged frames of each frame's worst violation of
    the decisions, judged in the reference's values (scores and classes as
    logits, overlaps as IoU), class-aware as NMS is: every reference
    candidate among its top ``max_candidates`` above the threshold that
    the program left out must be explained by the candidate cut, by a full
    set of slots that outrank it, or by a kept box of its own class that
    outranks and overlaps it past the IoU threshold (a kept box of the
    program's class c explains it only as far as the reference's logits at
    the candidate would have to move for c to be its best class: the
    larger of its best logit less its logit of c and the box's own
    shortfall in score or overlap); the shortfall of the best explanation
    is the violation.  So are two kept boxes of one class (the program's
    ids) that overlap past the threshold (by the smaller of the overlap's
    excess and their logit gap), a slot below the threshold or past the
    cut, a class id the reference's logits at the matched anchor do not
    put first (by its best logit less its logit of the program's class;
    infinite for an id outside the classes), and the global classifier
    budget: a classified slot must be eligible (above the threshold, its
    own box at or above the minimum area; else 1), no more slots than the
    budget classified (else 1), and an eligible slot left unclassified
    must be outranked by every classified one (1 where the budget was not
    full).  With one class and ids in range, every pair and every kept box
    is of one class and every class gap is 0: the checks are class-blind;
``prob``
    the worst, over the classified slots, of the classifier's largest
    probability gap against the reference's on the crop of the program's
    own box for that slot (the box is judged above; a box a few pixels
    off moves a crop, and a random classifier's answer with it) and of the
    gap by which the reference's probability of the program's label lies
    below the reference's best; and any probability on an eligible slot
    the budget left out, where the reference has none;
``stray``
    the share of the judged frames that stray: whose worst decision
    violation, median slot box gap or median slot score gap lies above
    :data:`STRAY` times the 90th percentile of the same per-frame value
    of the bf16 rendering (below).  The medians above see a fault only
    where it reaches half of the slots or frames; this counts a fault that
    drops, zeroes or moves the outputs of fewer frames.  A frame's box gap
    is its slots' median, not their worst: one slot's box may jump by a
    whole DFL bin (the stride, 8 pixels and more) where two bins of a
    random network's distribution all but tie, in the rendering as in the
    program, on a share of the frames that varies from seed to seed;
``cls_stray``
    the share of the classifier's gaps (each classified slot's, as in
    ``prob``, and each eligible slot's left out) above :data:`STRAY` times
    the rendering's 90th percentile of them: ``prob`` is one slot's worst
    and swings with it; this counts labels and probabilities altered on
    part of the batch.

A random network amplifies rounding here and there, so a few slots and
frames of a sound bf16 run read far above the rest (hence the medians,
and a share rather than a worst frame), and how far a sound run strays
differs tenfold from seed to seed.  So ``box``, ``score``, ``choice`` and
``prob`` are the program's gap over the same gap of the reference itself
computed on bf16 values, on the same weights and frames (the bf16
rendering): a sound bf16 program reads about 1, the control (fp8) and
the faults several times that; ``stray`` sets its thresholds from that
rendering too.  A cell compares the numbers its limits file names
(:func:`verdict`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from cardbench.reference.two_stage import Reference, box_area, box_iou, letterbox_params

NUMBERS = ("box", "score", "choice", "prob", "stray", "cls_stray")
# the least unit of each number: a bf16 rendering that happens to read
# nothing (no frame with a violation, say) does not make the unit 0
FLOORS = {"box": 0.05, "score": 1e-3, "choice": 1e-3, "prob": 1e-4}
# a frame strays where one of its worst gaps passes this many times the
# bf16 rendering's 90th percentile of that gap over the judged frames: on
# some seeds a sound program's decisions stray twice as far as the
# rendering's on every frame (the rendering does not round where the
# program's kernels do), and a cut at twice the tail counted up to a
# seventh of such a run's frames
STRAY = 3.0
STRAY_QUANTILE = 0.9
# per-frame worst gaps behind ``stray``, and the floor of each threshold's unit
FRAME_GAPS = {"frame_viol": "choice", "frame_box": "box", "frame_score": "score"}
BLOCK = 32  # frames per reference block
# a slot matches the anchor nearest in box and score together, each gap in
# these units (box: canvas pixels): a bf16 box may sit a few pixels nearer a
# neighbour's box, never with the neighbour's score as well
MATCH_PX = 4.0
MATCH_SCORE = 0.02
INF = float("inf")


def logit(p: torch.Tensor) -> torch.Tensor:
    """The detection score as the logit it came from (scores are sigmoids;
    their gaps shrink toward 0 and 1 where the logits' do not)."""
    p = p.clamp(1e-6, 1.0 - 1e-6)
    return torch.log(p) - torch.log1p(-p)


def _frame_checks(det: dict, prog: dict, sv: dict, ratio: float) -> dict:
    """Per-slot matches and the per-frame decision violations of one block
    (``ratio``: canvas pixels per frame pixel)."""
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

    logits, nc = det["cls_logits"], det["cls_logits"].shape[-1]
    c_prog = prog["det_class_ids"].long()
    c_ok = (c_prog >= 0) & (c_prog < nc)
    c_idx = c_prog.clamp(0, nc - 1)

    def class_gap(rows, best, ids):
        """Each row's logit of its class ``best`` above its logits of the
        classes ``ids``: rows (n, R, nc), best (n, R), ids (n, R, m)."""
        return torch.clamp(torch.gather(rows, 2, best[..., None]) - torch.gather(rows, 2, ids),
                           min=0.0)

    l_slot = torch.gather(logits, 1, a_star[..., None].expand(-1, -1, nc))  # (n, D, nc)
    cls_star = torch.gather(det["class_ids"], 1, a_star)
    slot_gap = class_gap(l_slot, cls_star, c_idx[..., None])[..., 0]
    viol = torch.maximum(viol, worst(torch.where(c_ok, slot_gap, INF), nmsv))
    # the decisions in logit units: score gaps near 0 and 1 shrink, logits' do not
    s_sorted, i_sorted = torch.sort(det["scores"], dim=-1, descending=True, stable=True)
    l_sorted, l_star, l_conf = logit(s_sorted), logit(s_star), float(logit(torch.tensor(conf)))
    a = s_sorted.shape[1]
    k = min(kcap, a)
    l_next = l_sorted[:, k] if a > k else torch.full((n,), -INF, device=scores.device)
    # kept slots: above the threshold, inside the candidate cut
    viol = torch.maximum(viol, worst(torch.clamp(l_conf - l_star, min=0.0), nmsv))
    viol = torch.maximum(viol, worst(torch.clamp(l_sorted[:, k - 1:k] - l_star, min=0.0), nmsv))
    # pairs of kept slots of one class
    pair_iou = box_iou(lb_star, lb_star)
    pair = (nmsv[:, :, None] & nmsv[:, None, :] & (c_prog[:, :, None] == c_prog[:, None, :])
            & ~torch.eye(d, dtype=torch.bool, device=scores.device))
    overlap = torch.minimum(pair_iou - thr, (l_star[:, :, None] - l_star[:, None, :]).abs())
    viol = torch.maximum(viol, worst(torch.clamp(overlap, min=0.0), pair))
    # reference candidates the program left out
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
    # a kept slot suppresses only its own class
    l_cand = torch.gather(logits, 1, cand[..., None].expand(-1, -1, nc))  # (n, k, nc)
    c_cand = torch.gather(det["class_ids"], 1, cand)
    cand_gap = class_gap(l_cand, c_cand, c_idx[:, None, :].expand(-1, k, -1))
    by_kept = torch.maximum(by_kept, torch.where(c_ok[:, None, :], cand_gap, INF))
    e_supp = torch.where(nmsv[:, None, :], by_kept, INF).amin(-1)
    missed = torch.minimum(torch.minimum(e_conf, e_full), torch.minimum(e_cut, e_supp))
    viol = torch.maximum(viol, worst(torch.clamp(missed, min=0.0), ~in_k & (s_c > conf)))
    return {"nmsv": nmsv, "box_gap": box_gap, "score_gap": (logit(scores) - l_star).abs(),
            "l_star": l_star, "viol": viol}


def judge_batch(ref: Reference, frames: torch.Tensor, prog: Dict[str, torch.Tensor]) -> dict:
    """Per-slot gaps and per-frame violations of one batch: ``frames`` (B,
    H, W, 3) uint8 on the reference's device, ``prog`` the program's
    outputs for them (any device; the whole batch, so that the global
    budget is judged as the program applied it)."""
    sv = ref.serving
    dev = ref.device
    prog = {k: torch.as_tensor(v).to(dev) for k, v in prog.items()}
    prog["boxes"] = prog["boxes"].float()
    prog["det_scores"] = prog["det_scores"].float()
    prog["cls_probs"] = prog["cls_probs"].float()
    b = frames.shape[0]
    ratio = letterbox_params(int(frames.shape[1]), int(frames.shape[2]), ref.size)[0]
    parts = []
    for i in range(0, b, BLOCK):
        det = ref.detect_all(frames[i:i + BLOCK])
        sl = {k: v[i:i + BLOCK] for k, v in prog.items()}
        parts.append(_frame_checks(det, sl, sv, ratio))
        del det
    m = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    nmsv, min_area = m["nmsv"], sv["min_area"]
    viol = m["viol"]  # (B,) worst decision violation of each frame

    def frame_worst(v, mask):
        return torch.where(mask, v, 0.0).amax(-1)

    def frame_median(v, mask):
        return torch.nan_to_num(torch.where(mask, v, float("nan")).nanmedian(-1).values, nan=0.0)

    classified = prog["valid"].bool()
    elig = nmsv & (box_area(prog["boxes"]) >= min_area)
    viol = torch.maximum(viol, frame_worst(torch.ones_like(m["l_star"]), classified & ~elig))
    budget = sv["cls_crop_budget_per_frame"] * b
    n_cls = int(classified.sum())
    if n_cls > budget:
        viol = torch.ones_like(viol)
    left = elig & ~classified
    if bool(left.any()):
        if n_cls >= budget and n_cls > 0:
            weakest = torch.where(classified, m["l_star"], INF).min()
            rank_expl = torch.clamp(m["l_star"] - weakest, min=0.0)
        else:
            rank_expl = torch.ones_like(m["l_star"])
        viol = torch.maximum(viol, frame_worst(rank_expl, left))
    # the classifier, on the crops of the program's own boxes
    img = torch.arange(b, device=dev)[:, None].expand_as(classified)
    prob_gaps = [torch.zeros(1, device=dev)]
    if bool(classified.any()):
        sel = classified.reshape(-1).nonzero().squeeze(-1)
        p_ref = torch.cat([
            ref.classify(frames, img.reshape(-1)[sel[j:j + 512]],
                         prog["boxes"].reshape(-1, 4)[sel[j:j + 512]])
            for j in range(0, sel.numel(), 512)])
        p_prog = prog["cls_probs"].reshape(-1, p_ref.shape[-1])[sel]
        lab = prog["cls_labels"].reshape(-1)[sel].long()
        lab_ok = (lab >= 0) & (lab < p_ref.shape[-1])
        p_lab = torch.gather(p_ref, 1, lab.clamp(0, p_ref.shape[-1] - 1)[:, None])[:, 0]
        label_gap = torch.where(lab_ok, p_ref.max(-1).values - p_lab, 1.0)
        prob_gaps.append(torch.maximum((p_prog - p_ref).abs().amax(-1), label_gap))
    if bool(left.any()):
        prob_gaps.append(prog["cls_probs"][left].abs().amax(-1))
    return {"box_gap": m["box_gap"][nmsv], "score_gap": m["score_gap"][nmsv],
            "frame_viol": viol, "prob_gap": torch.cat(prob_gaps),
            "frame_box": frame_median(m["box_gap"], nmsv),
            "frame_score": frame_median(m["score_gap"], nmsv)}


def gaps(ref: Reference, batches, keep: Optional[dict] = None) -> Dict[str, float]:
    """The pooled gaps of ``(frames, outputs)`` batches: the median box
    and score gaps, the median of the frames' violations, the worst
    probability gap; and, shown beside them, the worst slot's and frame's
    (``*_max``).  ``keep`` receives the per-slot and per-frame gaps."""
    got = [judge_batch(ref, frames, prog) for frames, prog in batches]
    pool = {k: torch.cat([g[k].float() for g in got]) for k in got[0]}
    if keep is not None:
        keep.update({k: v.cpu() for k, v in pool.items()})

    def q(t, x):
        return float(torch.quantile(t, x)) if t.numel() else 0.0

    return {
        "box": q(pool["box_gap"], 0.5),
        "score": q(pool["score_gap"], 0.5),
        "choice": q(pool["frame_viol"], 0.5),
        "prob": float(pool["prob_gap"].max()),
        "box_max": float(pool["box_gap"].max()) if pool["box_gap"].numel() else 0.0,
        "score_max": float(pool["score_gap"].max()) if pool["score_gap"].numel() else 0.0,
        "choice_max": float(pool["frame_viol"].max()),
        "slots": int(pool["score_gap"].numel()),
        "frames": int(pool["frame_viol"].numel()),
    }


def stray_share(prog: Dict[str, torch.Tensor], yard: Dict[str, torch.Tensor]):
    """(the program's share of straying frames, the rendering's own) from
    the per-frame worst gaps of both (:data:`FRAME_GAPS`)."""
    strays = {"prog": torch.zeros_like(prog["frame_viol"], dtype=torch.bool),
              "yard": torch.zeros_like(yard["frame_viol"], dtype=torch.bool)}
    for k, unit in FRAME_GAPS.items():
        cut = STRAY * max(float(torch.quantile(yard[k], STRAY_QUANTILE)), FLOORS[unit])
        strays["prog"] |= prog[k] > cut
        strays["yard"] |= yard[k] > cut
    return float(strays["prog"].float().mean()), float(strays["yard"].float().mean())


def judge(ref: Reference, bf16: Reference, batches, keep: Optional[dict] = None) -> Dict[str, float]:
    """:data:`NUMBERS` for ``(frames, outputs)`` batches: the program's
    gaps in units of the gaps of ``bf16`` (the reference computed on bf16
    values) on the same frames, each unit floored at :data:`FLOORS`, and
    the share of straying frames; with both sets of gaps beside them
    (``program.*``, ``bf16.*``), shown and not compared."""
    batches = list(batches)
    kept = ({}, {})
    prog = gaps(ref, batches, kept[0])
    yard = gaps(ref, [(frames, bf16.run_pipeline(frames)) for frames, _ in batches], kept[1])
    if keep is not None:
        keep.update(program=kept[0], bf16=kept[1])
    out = {k: prog[k] / max(yard[k], FLOORS[k]) for k in NUMBERS if "stray" not in k}
    out["stray"], yard["stray"] = stray_share(kept[0], kept[1])
    cut = STRAY * max(float(torch.quantile(kept[1]["prob_gap"], STRAY_QUANTILE)), FLOORS["prob"])
    out["cls_stray"] = float((kept[0]["prob_gap"] > cut).float().mean())
    yard["cls_stray"] = float((kept[1]["prob_gap"] > cut).float().mean())
    out.update({f"program.{k}": v for k, v in prog.items()})
    out.update({f"bf16.{k}": v for k, v in yard.items()})
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number the limits name is finite and within its
    limit."""
    return bool(limits) and all(
        numbers.get(k, float("nan")) == numbers.get(k, float("nan")) and numbers[k] <= v
        for k, v in limits.items())
