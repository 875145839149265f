"""The plain reference of the two-stage pipeline, float32.

Everything the program derives, worked out again from the raw inputs (the
uint8 frames and the raw state dicts, BatchNorm unfolded): the letterbox
(cv2's geometry: ``r = min(S/h, S/w)``, grey 114 padding split as
``round(d - 0.1)`` / ``round(d + 0.1)``, half-pixel bilinear), x 1/255 and
BGR -> RGB, the detector with BatchNorm in eval mode, the DFL decode of
every anchor, the stable top-K, greedy NMS (IoU with a 1e-6 denominator
epsilon), the per-frame crop budget, the unmapping and clipping, the
min-area floor, the ROI crop (each box floored, 2-tap half-pixel bilinear
at ``out x out``), the classifier's normalisation, the global classifier
budget (a stable top-k of the batch's detection scores) and the softmax.

:meth:`Reference.detect_all` gives the per-anchor values the judge
(``cardbench/judge.py``) holds the program's outputs against;
:meth:`Reference.run_pipeline` gives outputs in the program's own format,
which is how the control (``quant="fp8"``) stands in the program's place.

It imports nothing of the program: models come from the frozen copies
beside this file, named by the configuration.  TF32 is off while it runs.
"""

from __future__ import annotations

import contextlib
import importlib

import torch
import torch.nn.functional as F
from torch import nn

PAD_VALUE = 114.0
IOU_EPS = 1e-6
FP8_MAX = 448.0  # largest finite float8_e4m3fn


@contextlib.contextmanager
def tf32_off():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def build_model(spec: dict) -> nn.Module:
    """The reference model that ``spec["reference"]`` names: a module of
    this package with a ``build(spec)`` function."""
    module = importlib.import_module(f"cardbench.reference.{spec['reference']}")
    return module.build(spec)


def fp8(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 values under a scale that maps its
    largest magnitude (per tensor, or per slice along ``dim``) to 448."""
    if dim is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=[d for d in range(x.dim()) if d != dim], keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def quantize_fp8(model: nn.Module) -> nn.Module:
    """Every conv and linear layer of ``model`` computing on fp8 values:
    weights rounded per output channel once, inputs per tensor at each
    call.  The control's precision, one step below bf16."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            with torch.no_grad():
                m.weight.copy_(fp8(m.weight, dim=0))
            m.register_forward_pre_hook(lambda mod, args: (fp8(args[0]),))
    return model


def letterbox_params(h: int, w: int, s: int):
    """(ratio, dw, dh, new_w, new_h, top, left) of cv2's letterbox."""
    r = min(s / h, s / w)
    new_w, new_h = int(round(w * r)), int(round(h * r))
    dw, dh = (s - new_w) / 2, (s - new_h) / 2
    return r, dw, dh, new_w, new_h, int(round(dh - 0.1)), int(round(dw - 0.1))


def anchors(size: int, strides, device):
    """(points (A, 2) cell centres in grid units, strides (A, 1))."""
    pts, st = [], []
    for s in strides:
        n = size // s
        g = torch.arange(n, dtype=torch.float32, device=device) + 0.5
        gy, gx = torch.meshgrid(g, g, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        st.append(torch.full((n * n, 1), float(s), device=device))
    return torch.cat(pts), torch.cat(st)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, 4) x (..., N, 4) xyxy -> (..., M, N), areas clamped at 0."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    wh = torch.clamp(torch.minimum(a[..., 2:], b[..., 2:]) - torch.maximum(a[..., :2], b[..., :2]),
                     min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (box_area(a) + box_area(b) - inter + IOU_EPS)


def box_area(b: torch.Tensor) -> torch.Tensor:
    return torch.clamp(b[..., 2] - b[..., 0], min=0.0) * torch.clamp(b[..., 3] - b[..., 1], min=0.0)


def stable_topk(x: torch.Tensor, k: int):
    """Top ``k`` along the last axis, descending, ties to the lower index."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def crop_axis(start, extent, limit: int, out: int):
    """2-tap half-pixel sampling along one axis: (i0, i1, w0, w1), each
    (N, out), for floored starts and extents (N,)."""
    o = torch.arange(out, dtype=torch.float32, device=start.device) + 0.5
    u = o * (extent / out)[:, None] - 0.5 + start[:, None]
    u = torch.clamp(u, 0.0, limit - 1.0)
    g0 = torch.floor(u)
    w0 = torch.clamp(1.0 - (u - g0).abs(), min=0.0)
    w1 = torch.clamp(1.0 - (u - g0 - 1.0).abs(), min=0.0)
    return g0.long(), torch.clamp(g0 + 1.0, max=limit - 1.0).long(), w0, w1


def crop(frames: torch.Tensor, image: torch.Tensor, boxes: torch.Tensor, out: int):
    """Crops (N, out, out, 3) float32 0-255 of ``frames`` (B, H, W, 3) at
    xyxy ``boxes`` (N, 4) of frames ``image`` (N,)."""
    h, w = int(frames.shape[1]), int(frames.shape[2])
    x1, y1 = torch.floor(boxes[:, 0]), torch.floor(boxes[:, 1])
    bw = torch.clamp(torch.floor(boxes[:, 2]) - x1, min=1.0)
    bh = torch.clamp(torch.floor(boxes[:, 3]) - y1, min=1.0)
    r0, r1, wr0, wr1 = crop_axis(y1, bh, h, out)
    c0, c1, wc0, wc1 = crop_axis(x1, bw, w, out)
    img = image[:, None, None]
    f = frames
    rows = [(r0, wr0), (r1, wr1)]
    cols = [(c0, wc0), (c1, wc1)]
    acc = torch.zeros((boxes.shape[0], out, out, frames.shape[-1]), device=frames.device)
    for ri, rw in rows:
        for ci, cw in cols:
            px = f[img, ri[:, :, None], ci[:, None, :]].float()
            acc += px * (rw[:, :, None] * cw[:, None, :])[..., None]
    return acc


class Reference:
    """The reference pipeline of one configuration on ``device``, with the
    raw state dicts loaded.  ``quant="fp8"`` makes it the control;
    ``quant="bf16"`` computes the models on bf16 weights and activations
    (BatchNorm in float32 on them, as deployed bf16 models normalise: in
    bf16, ``x - mean`` of two values near 5 keeps two bits), the judge's
    yardstick of how far a sound bf16 rendering of these weights strays on
    these frames."""

    def __init__(self, config: dict, det_state, cls_state, device, quant=None):
        self.cfg = config
        self.device = torch.device(device)
        self.serving = config["serving"]
        det, cls = config["detector"], config["classifier"]
        self.size = det["input_size"]
        self.reg_max = det["reg_max"]
        self.dtype = torch.bfloat16 if quant == "bf16" else torch.float32
        self.det = self._load(build_model(det), det_state, quant)
        self.cls = self._load(build_model(cls), cls_state, quant)
        self.cls_size = cls["input_size"]
        self.mean = torch.tensor(cls["mean"], device=self.device)
        self.std = torch.tensor(cls["std"], device=self.device)
        self.points, self.strides = anchors(self.size, det["strides"], self.device)

    def _load(self, model, state, quant):
        model.load_state_dict({k: v.float() for k, v in state.items()})
        model = model.to(device=self.device, dtype=self.dtype).eval()
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.float()
        return quantize_fp8(model) if quant == "fp8" else model

    def _rgb(self, x: torch.Tensor, channel_dim: int) -> torch.Tensor:
        return x.flip(channel_dim) if self.serving["input_color"] == "bgr" else x

    def letterbox(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, 3, S, S) float32 in 0-255, host order."""
        b, h, w = frames.shape[:3]
        s = self.size
        _, _, _, new_w, new_h, top, left = letterbox_params(h, w, s)
        x = frames.permute(0, 3, 1, 2).float()
        if (new_w, new_h) != (w, h):
            x = F.interpolate(x, size=(new_h, new_w), mode="bilinear", align_corners=False,
                              antialias=False)
        canvas = torch.full((b, 3, s, s), PAD_VALUE, device=frames.device)
        canvas[:, :, top:top + new_h, left:left + new_w] = x
        return canvas

    @torch.no_grad()
    def detect_all(self, frames: torch.Tensor) -> dict:
        """Every anchor of every frame: ``scores`` (B, A) sigmoid class
        maxima, ``class_ids`` (B, A) (the first maximal class),
        ``cls_logits`` (B, A, nc) float32 (the head's own, no copy),
        ``boxes_lb`` (B, A, 4) xyxy in canvas pixels, ``boxes`` (B, A, 4)
        unmapped and clipped to the frame."""
        with tf32_off():
            x = self._rgb(self.letterbox(frames) * (1.0 / 255.0), 1)
            head = {k: v.float() for k, v in self.det(x.to(self.dtype)).items()}
        scores, class_ids = torch.sigmoid(head["cls"]).max(dim=-1)
        n, a = scores.shape
        bins = torch.arange(self.reg_max, dtype=torch.float32, device=scores.device)
        dist = (torch.softmax(head["reg"].float().reshape(n, a, 4, self.reg_max), -1) * bins).sum(-1)
        lt, rb = dist[..., :2], dist[..., 2:]
        boxes_lb = torch.cat([self.points - lt, self.points + rb], -1) * self.strides
        h, w = int(frames.shape[1]), int(frames.shape[2])
        r, dw, dh = letterbox_params(h, w, self.size)[:3]
        shift = torch.tensor([dw, dh, dw, dh], device=scores.device)
        fr = (boxes_lb - shift) / r
        lim = torch.tensor([w, h, w, h], dtype=torch.float32, device=scores.device)
        boxes = torch.minimum(torch.clamp(fr, min=0.0), lim)
        return {"scores": scores, "class_ids": class_ids, "cls_logits": head["cls"],
                "boxes_lb": boxes_lb, "boxes": boxes}

    @torch.no_grad()
    def classify(self, frames: torch.Tensor, image: torch.Tensor, boxes: torch.Tensor):
        """Softmax probabilities (N, classes) of the crops at frame-pixel
        ``boxes`` (N, 4) of frames ``image`` (N,)."""
        if boxes.shape[0] == 0:
            return torch.zeros((0, self.cfg["classifier"]["num_classes"]), device=self.device)
        x = self._rgb(crop(frames, image, boxes, self.cls_size) * (1.0 / 255.0), -1)
        x = ((x - self.mean) / self.std).permute(0, 3, 1, 2).contiguous()
        with tf32_off():
            return torch.softmax(self.cls(x.to(self.dtype)).float(), dim=-1)

    @torch.no_grad()
    def run_pipeline(self, frames: torch.Tensor) -> dict:
        """The program's outputs for ``frames`` as the reference computes
        them: ``boxes``, ``det_scores``, ``det_class_ids``, ``valid``,
        ``cls_probs``, ``cls_labels``, ``cls_scores``."""
        sv = self.serving
        det = self.detect_all(frames)
        del det["cls_logits"]
        n = det["scores"].shape[0]
        k = min(sv["max_candidates"], det["scores"].shape[1])
        top_s, idx = stable_topk(det["scores"], k)
        take = lambda t: torch.gather(t, 1, idx[..., None].expand(-1, -1, 4))  # noqa: E731
        lb, fr = take(det["boxes_lb"]), take(det["boxes"])
        cid = torch.gather(det["class_ids"], 1, idx)
        keep = torch.zeros_like(top_s, dtype=torch.bool)
        iou = box_iou(lb, lb)
        same = cid[:, :, None] == cid[:, None, :]
        for i in range(k):
            over = (iou[:, :i, i] > sv["iou_threshold"]) & same[:, :i, i] & keep[:, :i]
            keep[:, i] = (top_s[:, i] > sv["conf_threshold"]) & ~over.any(-1)
        d = sv["crop_det_budget"] or sv["max_detections"]
        d = min(d, sv["max_detections"])
        kept_s, sel = stable_topk(torch.where(keep, top_s, -1.0), d)
        valid = kept_s > sv["conf_threshold"]
        boxes = torch.where(valid[..., None], torch.gather(fr, 1, sel[..., None].expand(-1, -1, 4)), 0.0)
        scores = torch.where(valid, kept_s, 0.0)
        cids = torch.where(valid, torch.gather(cid, 1, sel), -1).int()
        valid = valid & (box_area(boxes) >= sv["min_area"])
        budget = sv["cls_crop_budget_per_frame"] * n
        ranking = torch.where(valid, scores, -1.0).reshape(-1)
        _, chosen = stable_topk(ranking, min(budget, ranking.numel()))
        image = torch.arange(n, device=frames.device).repeat_interleave(d)
        probs_sel = self.classify(frames, image[chosen], boxes.reshape(-1, 4)[chosen])
        c = self.cfg["classifier"]["num_classes"]
        probs = torch.zeros((n * d, c), device=frames.device).index_copy_(0, chosen, probs_sel)
        taken = torch.zeros(n * d, dtype=torch.bool, device=frames.device)
        taken[chosen] = True
        valid = valid & taken.reshape(n, d)
        probs = probs.reshape(n, d, c)
        return {"boxes": boxes, "det_scores": scores, "det_class_ids": cids, "valid": valid,
                "cls_probs": probs, "cls_labels": probs.argmax(-1).int(),
                "cls_scores": probs.amax(-1)}
