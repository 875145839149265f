"""The two-stage detect -> crop -> classify pipeline in PyTorch.

:meth:`TwoStagePipeline.run_fused` reproduces the JAX package's fused
serving program stage for stage: stem on raw pixels (the stem kernel on
canvas-sized frames, else letterbox + a stem conv with the input scale
folded in) -> detector -> DFL decode + top-K -> NMS (kernel) -> per-frame
crop budget -> un-letterbox, clip, min-area -> ROI crop (kernel) -> global
classifier budget -> classifier -> softmax.  Shapes are static: NMS
emits ``max_detections`` padded slots and ``valid`` masks the real ones.
On device-resident frames it never synchronises the host with the card.

The default detector is YoloLitePi.  Any other detector module plugs in as
``det_model`` (YoloV11, YoloV5 with either head, ...); it then runs as the
JAX package runs an injected detector: letterbox, x 1/255, BGR -> RGB, the
whole model with its BatchNorm, and ``candidate_decoder`` in place of the
DFL decode where its head needs one.  A detector that defines
``deploy_form(state)`` runs in the deployed form that method returns
(YoloV9E: its RepConvs folded).  The classifier is any of
``models/registry.py``'s four.

The staged programs (:meth:`~TwoStagePipeline.detect`,
:meth:`~TwoStagePipeline.detect_candidates`,
:meth:`~TwoStagePipeline.classify`) are the JAX package's: the detector on
pre-letterboxed [0, 1] canvases, and the classifier on crops.

On a CUDA device the stem, NMS and ROI crop run as the hand-written
kernels in ``csrc/`` and the detector runs channels last; on the CPU
(``device="cpu"``, the tests) the kernels' plain versions run and the
detector NCHW.
"""

from __future__ import annotations

import contextlib
import copy
import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from litepi_tpu_torch.core.device import resolve_device
from litepi_tpu_torch.core.metrics import span
from litepi_tpu_torch.core.types import PipelineConfig
from litepi_tpu_torch.kernels.stem import pack_stem_params
from litepi_tpu_torch.models import YoloLitePi, build_classifier
from litepi_tpu_torch.models.layers import CLASSIFIER_BN_EPS, to_channels_last
from litepi_tpu_torch.ops.anchors import make_anchors
from litepi_tpu_torch.ops.boxes import box_area, clip_boxes
from litepi_tpu_torch.ops.dfl import decode_candidates, topk_stable
from litepi_tpu_torch.ops.letterbox import letterbox_nchw, letterbox_params
from litepi_tpu_torch.ops.nms import nms_sorted
from litepi_tpu_torch.ops.roi import (
    crop_and_resize,
    crop_and_resize_pyramid,
    crop_and_resize_windowed,
)
from litepi_tpu_torch.ops.stem import ROW_MULTIPLE, fused_stem
from litepi_tpu_torch.parallel.mesh import all_gather_rows
from litepi_tpu_torch.weights.fold_bn import (
    BN_EPS,
    fold_pipeline_state,
    fold_stem_input,
    stem_kernel_hwio,
)
from litepi_tpu_torch.weights.graph_ops import tf32_allowed
from litepi_tpu_torch.weights.jax_bridge import jax_to_state_dict
from litepi_tpu_torch.weights.seeded import seeded_state

StateDict = Dict[str, torch.Tensor]
# (head output, k) -> (boxes (B, k, 4), scores (B, k), class_ids (B, k))
CandidateDecoder = Callable[
    [Dict[str, torch.Tensor], int], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
]


def _in_precision(method):
    """Runs the entry point ``method`` inside its pipeline's
    :meth:`~TwoStagePipeline.precision` scope."""

    @functools.wraps(method)
    def scoped(self, *args, **kwargs):
        with self.precision():
            return method(self, *args, **kwargs)

    return scoped


class TwoStagePipeline:
    """Holds the deploy-form models and runs the fused program.

    ``det_state`` / ``cls_state`` are ``state_dict``s of
    :class:`~litepi_tpu_torch.models.YoloLitePi` (or of ``det_model``) and
    the classifier, with BatchNorm (folded here: eps 1e-3 / 1e-5, the
    injected detector's kept) or already deploy-form.
    ``dtype`` is float32 or bfloat16: weights and activations take it,
    decode and softmax run in float32.  A float32 pipeline runs each
    entry point (``run_fused``, ``detect``,
    ``detect_candidates``, ``classify``) with TF32 for cuDNN convs and
    matmuls set to ``allow_tf32`` (off by default: float32 here means
    float32, as on the JAX side) and gives the caller's flags back after
    it (:meth:`precision`).
    """

    def __init__(
        self,
        cfg: PipelineConfig,
        det_state: StateDict,
        cls_state: StateDict,
        dtype: torch.dtype = torch.float32,
        device="cuda",
        det_model: Optional[nn.Module] = None,
        candidate_decoder: Optional[CandidateDecoder] = None,
        candidate_capacity: Optional[int] = None,
        allow_tf32: bool = False,
    ) -> None:
        self.device = resolve_device(device)
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        if cfg.roi_impl not in ("dense", "pallas", "windowed"):
            raise ValueError(f"unknown roi_impl {cfg.roi_impl!r}")
        self.cfg = cfg
        self.dtype = dtype
        self.allow_tf32 = allow_tf32

        # any detector with the {reg, cls} output contract plugs in
        # (YoloV11, anchor-free YoloV5, ...); a detector with another head
        # (anchor-based YoloV5) brings ``candidate_decoder(out, k) -> (boxes,
        # scores, class_ids)``, the top-k score-descending candidates in
        # input pixels, and its prediction count as ``candidate_capacity``
        self._candidate_decoder = candidate_decoder
        self._injected = det_model is not None
        if self._injected:
            # an injected detector runs with its BatchNorm, on [0, 1] RGB
            # canvases: no BN fold, no stem-input fold, no stem kernel.  It
            # runs as given, or in the form its own ``deploy_form(state) ->
            # (model, state)`` returns where it defines one (YOLOv9-E folds
            # its RepConvs there, from the float32 state, before _place
            # rounds it)
            deploy_form = getattr(det_model, "deploy_form", None)
            if deploy_form is None:
                det_model = copy.deepcopy(det_model)
            else:
                det_model, det_state = deploy_form(det_state)
            self.det_model = self._place(det_model, det_state)
        else:
            self._init_default_detector(det_state)
        # cuDNN's bf16 convs on the card are NHWC: it transposes NCHW
        # activations in and out, and copies NCHW weights, on every call.  So
        # on the card the detector's weights are placed channels last here,
        # once, and its input made so where it enters (_det_input)
        if self.device.type == "cuda":
            to_channels_last(self.det_model)

        cls_state = fold_pipeline_state(cls_state, CLASSIFIER_BN_EPS)
        self.cls_model = self._place(
            build_classifier(
                cfg.classifier_arch, cfg.num_classifier_classes, fused=True
            ),
            cls_state,
            float32=("fc",),  # the JAX classifier's Dense is float32
        )

        pts, strides = make_anchors(cfg.det_input_size, cfg.detector.strides)
        self._anchors = torch.as_tensor(pts, device=self.device)
        self._strides = torch.as_tensor(strides, device=self.device)
        # eval_max_candidates=0 means every prediction of the detector: the
        # anchor-free grid, or the decoder's own count (3x for YOLOv5's
        # anchor-based head)
        self._candidate_capacity = int(
            candidate_capacity if candidate_capacity is not None else pts.shape[0]
        )
        self._mean = torch.tensor(cfg.cls_mean, dtype=torch.float32, device=self.device)
        self._std = torch.tensor(cfg.cls_std, dtype=torch.float32, device=self.device)
        # letterbox geometry tensors per frame size, made once on the device
        self._unmap_geometry: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}

    def _init_default_detector(self, det_state: StateDict) -> None:
        """The default detector, YoloLitePi, in deploy form with the stem
        kernel's weights."""
        cfg = self.cfg
        det_state = fold_pipeline_state(det_state, BN_EPS)
        self.det_model = self._place(YoloLitePi(cfg.detector, fused=True), det_state)
        # the port always runs the deploy form, so the fused program feeds
        # raw 0-255 pixels in the host's colour order to a stem whose
        # kernel has the 1/255 scale and the BGR->RGB flip folded in
        # (weights/fold_bn.py): the stem kernel's float32 HWIO kernel for
        # canvas-sized frames (with its host copy, packed once here as the
        # kernel's parameter block, so no call reads the weights back), a
        # conv module for letterboxed canvases.  In bf16 the stem kernel's
        # weights and bias are the bf16 values the JAX package's bf16 stem
        # conv casts them to (the kernel still multiplies in float32)
        stem_w = det_state["backbone.stem.conv.weight"].float()
        flip = cfg.input_color == "bgr"
        stem_kernel = stem_kernel_hwio(stem_w, flip).to(self.dtype).float()
        stem_bias = det_state["backbone.stem.conv.bias"].to(self.dtype).float()
        self._stem_params = pack_stem_params(stem_kernel.reshape(27, -1), stem_bias)
        self._stem_kernel = stem_kernel.to(self.device)
        self._stem_bias = stem_bias.to(self.device)
        # a copy taken before the channels-last placement: with 3 input
        # channels the stem conv ran slower channels last (5.10 ms against
        # 4.77 ms NCHW with its output converted, B=256 on an H100)
        raw_stem = copy.deepcopy(self.det_model.backbone.stem)
        with torch.no_grad():
            raw_stem.conv.weight.copy_(fold_stem_input(stem_w, 1.0 / 255.0, flip))
        self._raw_stem = raw_stem

    def _place(self, model: nn.Module, state: StateDict, float32=()) -> nn.Module:
        """``model`` on the device in the pipeline's dtype with ``state``
        loaded.  BatchNorm (an injected detector keeps it) and the
        submodules named in ``float32`` stay float32 with the state's
        values unrounded, as the JAX models keep them (flax BatchNorm's
        float32 parameters and statistics, the classifiers' float32
        ``Dense``); BatchNorm normalises in float32 and returns the
        activations in their own dtype."""
        model = model.eval().to(device=self.device, dtype=self.dtype)
        for name, m in model.named_modules():
            if isinstance(m, nn.BatchNorm2d) or name in float32:
                m.float()
        model.load_state_dict(state)
        return model

    def precision(self) -> contextlib.AbstractContextManager:
        """The TF32 scope of this pipeline's work: a float32 pipeline sets
        cuDNN's and matmul's TF32 flags to ``allow_tf32`` and restores the
        caller's on exit (the flags act on the card only); a bf16 pipeline
        changes nothing."""
        if self.dtype == torch.float32:
            return tf32_allowed(self.allow_tf32)
        return contextlib.nullcontext()

    # ------------------------------------------------------------------ #
    # construction helpers                                                #
    # ------------------------------------------------------------------ #

    @classmethod
    def initialize(
        cls,
        cfg: PipelineConfig,
        seed: int = 0,
        dtype: torch.dtype = torch.float32,
        device="cuda",
        det_model: Optional[nn.Module] = None,
        candidate_decoder: Optional[CandidateDecoder] = None,
        candidate_capacity: Optional[int] = None,
    ) -> "TwoStagePipeline":
        """A pipeline with freshly initialised (untrained) weights,
        ``weights/seeded.py::seeded_state`` of seeds ``seed`` (detector:
        YoloLitePi, or ``det_model``) and ``seed + 1`` (classifier)."""
        resolve_device(device)
        det = YoloLitePi(cfg.detector) if det_model is None else copy.deepcopy(det_model)
        clf = build_classifier(cfg.classifier_arch, cfg.num_classifier_classes)
        return cls(
            cfg, seeded_state(det, seed), seeded_state(clf, seed + 1), dtype, device,
            det_model, candidate_decoder, candidate_capacity,
        )

    @classmethod
    def from_jax_vars(
        cls,
        cfg: PipelineConfig,
        det_vars,
        cls_vars,
        dtype: torch.dtype = torch.float32,
        device="cuda",
        det_model: Optional[nn.Module] = None,
        candidate_decoder: Optional[CandidateDecoder] = None,
        candidate_capacity: Optional[int] = None,
    ) -> "TwoStagePipeline":
        """A pipeline on the JAX package's variables (numpy trees, folded
        or not) through ``weights/jax_bridge.py``; ``det_vars`` are
        ``det_model``'s where one is given."""
        resolve_device(device)
        return cls(
            cfg, jax_to_state_dict(det_vars), jax_to_state_dict(cls_vars),
            dtype, device, det_model, candidate_decoder, candidate_capacity,
        )

    # ------------------------------------------------------------------ #
    # stages                                                              #
    # ------------------------------------------------------------------ #

    # Each stage below is one step of run_fused, in its order.  Under a
    # profiler, run_fused marks them with the spans litepi.stem, .detect,
    # .candidates, .suppress, .unmap, .crop and .classify inside one
    # litepi.run_fused per call (core/metrics.py::span).

    def _canvas_sized(self, frames: torch.Tensor) -> bool:
        """True when frames are (B, S, S, 3) at the detector's input size S
        and S is a size the stem kernel takes: the letterbox is then the
        identity and the stem runs on the uint8 frames."""
        s = self.cfg.det_input_size
        return tuple(frames.shape[1:3]) == (s, s) and s % ROW_MULTIPLE == 0

    def _letterbox(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, 3, S, S) letterboxed canvas, 0-255."""
        return letterbox_nchw(frames, self.cfg.det_input_size, self.dtype)

    def _stem(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 frames -> (B, c0, S/2, S/2) NCHW stem
        activations in the pipeline's dtype, the input scale and colour flip
        folded into the weights.

        The frame shape alone picks the branch: canvas-sized frames go
        through :func:`~litepi_tpu_torch.ops.stem.fused_stem` (the stem
        kernel on the card) with float32 weights and no letterbox; other
        sizes through the letterbox and a conv module in the pipeline's
        dtype.  A failing kernel raises; it never selects the other branch.

        With an injected detector this stage is the letterbox and the 1/255
        scale: (B, 3, S, S) canvases in [0, 1], host colour order.
        """
        if self._injected:
            return self._letterbox(frames) * (1.0 / 255.0)
        if self._canvas_sized(frames):
            act = fused_stem(
                frames, self._stem_kernel, self._stem_bias, self.dtype, self._stem_params
            )
            return act.permute(0, 3, 1, 2)
        return self._raw_stem(self._letterbox(frames))

    def _det_input(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` in the detector's layout: dense channels last on the card,
        as it comes on the CPU."""
        if self.device.type == "cuda":
            return x.contiguous(memory_format=torch.channels_last)
        return x

    def _detect(self, stem_act: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Stem activations -> head output ``{reg, cls}``: the detector
        after its stem.  An injected detector runs whole on the [0, 1]
        canvases, flipped to RGB first where the host sends BGR."""
        if self._injected and self.cfg.input_color == "bgr":
            stem_act = stem_act.flip(1)
        stem_act = self._det_input(stem_act)
        if self._injected:
            return self.det_model(stem_act)
        return self.det_model(stem_act, from_stem=True)

    def _candidates(self, head: Dict[str, torch.Tensor], k: Optional[int] = None):
        """Top-``k`` (default ``max_candidates``) score-descending
        candidates: boxes (B, K, 4) in input pixels, scores (B, K), class
        ids; from the candidate decoder where one is given, else DFL decode
        + top-K."""
        cfg = self.cfg
        k = k or cfg.nms.max_candidates
        if self._candidate_decoder is not None:
            return self._candidate_decoder(head, k)
        return decode_candidates(
            head, self._anchors, self._strides, cfg.detector.reg_max, k,
            cfg.candidate_selector,
        )

    def _suppress(self, boxes, scores, class_ids, conf: float):
        """NMS (kernel on the card), then the per-frame crop budget."""
        nms_cfg = self.cfg.nms
        b, s, c, v = nms_sorted(
            boxes, scores, class_ids, conf, nms_cfg.iou_threshold,
            nms_cfg.max_detections,
        )
        d2 = self.cfg.crop_det_budget
        if d2 and d2 < nms_cfg.max_detections:
            # slots are score-descending, so the budget is a static slice
            # taken before every later stage
            b, s, c, v = b[:, :d2], s[:, :d2], c[:, :d2], v[:, :d2]
        return b, s, c, v

    def _geometry(self, h: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(shift (4,), ratio ()) float32 device tensors of the letterbox of
        an h x w frame, made once per size by fill kernels (no copy from
        the host, so no synchronisation)."""
        geo = self._unmap_geometry.get((h, w))
        if geo is None:
            ratio, dw, dh, _, _ = letterbox_params(h, w, self.cfg.det_input_size)
            shift = torch.empty(4, dtype=torch.float32, device=self.device)
            shift[0::2].fill_(dw)
            shift[1::2].fill_(dh)
            ratio_t = torch.full((), ratio, dtype=torch.float32, device=self.device)
            geo = self._unmap_geometry[(h, w)] = (shift, ratio_t)
        return geo

    def _on_device(self, x) -> torch.Tensor:
        """``x`` as a float32 tensor on the pipeline's device.  Host data
        goes up through pinned memory without blocking the host."""
        if isinstance(x, torch.Tensor) and x.device == self.device:
            return x.float()
        t = torch.as_tensor(x, dtype=torch.float32)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _unmap(self, boxes, valid, h: int, w: int, area_scale=None):
        """Letterbox boxes -> clipped frame pixels; ``valid`` loses the
        boxes under ``min_area`` (areas times ``area_scale`` (B,) if given,
        a device tensor or host values)."""
        shift, ratio = self._geometry(h, w)
        # true division by a device tensor, as XLA divides (a CUDA divide by
        # a Python float multiplies by 1/ratio)
        orig_boxes = clip_boxes((boxes - shift) / ratio, w, h)
        area = box_area(orig_boxes)
        if area_scale is not None:
            area = area * self._on_device(area_scale)[:, None]
        return orig_boxes, valid & (area >= self.cfg.nms.min_area)

    def _crop(self, frames, boxes, valid) -> torch.Tensor:
        """ROI crop (kernel on the card) -> (B, D, c, c, 3) float32 in [0, 1];
        both crops round as the JAX crops in the pipeline's dtype."""
        size = self.cfg.cls_input_size
        if self.cfg.roi_impl == "windowed":
            crops = crop_and_resize_windowed(frames, boxes, valid, size, self.dtype,
                                             self.cfg.roi_window)
        else:
            crop = crop_and_resize_pyramid if self.cfg.roi_impl == "pallas" else crop_and_resize
            crops = crop(frames, boxes, valid, size, compute_dtype=self.dtype)
        return crops * (1.0 / 255.0)

    def _classify(self, crops01: torch.Tensor) -> torch.Tensor:
        """(N, c, c, 3) float32 crops in [0, 1], host colour order ->
        (N, num_classes) float32 probabilities."""
        if self.cfg.input_color == "bgr":
            crops01 = crops01.flip(-1)
        x = (crops01 - self._mean) / self._std
        logits = self.cls_model(x.permute(0, 3, 1, 2))
        return torch.softmax(logits.float(), dim=-1)

    def _classify_budgeted(self, crops, scores, valid, group=None):
        """Classifier under ``cls_crop_budget``: (B, D, classes) probabilities
        and ``valid`` cleared where a crop went unclassified.

        With ``group`` (the data ranks of a mesh, ``parallel/mesh.py``) the
        budget is global, over the B·D slots of every rank's frames, as the
        JAX package's budget is under a batch-sharded ``jit``: the ranks
        gather their ranking scores (a few KB), each takes the same stable
        global top-k, and since the slots that the global selection takes
        on a rank are a prefix of that rank's own stable ranking, each rank
        classifies its top ``min(budget, B·D)`` crops and clears those past
        its count, computed on the device (static shapes, no sync)."""
        n, d = crops.shape[0], crops.shape[1]
        flat = crops.reshape(n * d, *crops.shape[2:])
        budget = self.cfg.cls_crop_budget
        ranks = 1 if group is None else dist.get_world_size(group)
        if not budget or budget >= n * d * ranks:
            return self._classify(flat).reshape(n, d, -1), valid
        # global compaction: rank every slot by detection score (invalid
        # slots tie at -1; the stable sort takes the lowest indices, as
        # jax.lax.top_k does), classify the top ``budget`` crops and scatter
        # the probabilities back (device-side scatters: an index assignment
        # of a Python scalar would copy it from the host and synchronise)
        ranking = torch.where(valid, scores, -1.0).reshape(n * d)
        _, sel = topk_stable(ranking, min(budget, n * d))
        sel_probs = self._classify(flat.index_select(0, sel))
        taken = torch.ones(sel.shape, dtype=torch.bool, device=self.device)
        if ranks > 1:
            _, global_sel = topk_stable(all_gather_rows(ranking, group), budget)
            first = dist.get_rank(group) * n * d
            count = ((global_sel >= first) & (global_sel < first + n * d)).sum()
            taken = torch.arange(sel.shape[0], device=self.device) < count
            sel_probs = torch.where(taken[:, None], sel_probs, 0.0)
        probs = torch.zeros(
            (n * d, sel_probs.shape[-1]), dtype=sel_probs.dtype, device=self.device
        ).index_copy_(0, sel, sel_probs)
        kept = torch.zeros(n * d, dtype=torch.bool, device=self.device).index_copy_(
            0, sel, taken
        )
        return probs.reshape(n, d, -1), valid & kept.reshape(n, d)

    @_in_precision
    @torch.inference_mode()
    def run_fused(
        self,
        frames,
        conf_threshold: Optional[float] = None,
        area_scale=None,
        group=None,
    ) -> Dict[str, torch.Tensor]:
        """Full two-stage pipeline on raw same-resolution frames.

        frames: (B, H, W, 3) uint8 (numpy or tensor) in ``cfg.input_color``
        order.  ``area_scale`` (B,): per-frame multiplier of box areas
        before the min-area floor, a device tensor or host values (copied
        up without blocking).  Returns tensors on the pipeline's device:
        boxes (B, D, 4) in frame pixels, det_scores (B, D), det_class_ids
        (B, D) int32, valid (B, D) bool, cls_probs (B, D, classes),
        cls_labels (B, D) int32, cls_scores (B, D), with D =
        ``max_detections`` or ``crop_det_budget``.  On frames and an
        ``area_scale`` already on the card it issues its work without
        synchronising the host.  ``group``: the data ranks of a mesh whose
        frames together make the global batch (``pipeline/serving.py``);
        the classifier budget is then global, the one cross-frame step.
        """
        conf = self.cfg.benchmark_conf if conf_threshold is None else conf_threshold
        # every operation the call issues lies under one stage span, the
        # frames' upload under the stem's.  The stem's output is handed on
        # in a list, so that the detector's call holds its only reference
        # and frees it as soon as it is consumed (the injected detector's
        # colour flip and the layout conversion free it before the model
        # runs)
        with span("run_fused"):
            with span("stem"):
                frames = torch.as_tensor(frames).to(self.device).contiguous()
                if frames.dtype != torch.uint8 or frames.dim() != 4:
                    raise ValueError("frames must be (B, H, W, 3) uint8")
                stem_act = [self._stem(frames)]
            h, w = int(frames.shape[1]), int(frames.shape[2])
            with span("detect"):
                head = self._detect(stem_act.pop())
            with span("candidates"):
                candidates = self._candidates(head)
            with span("suppress"):
                b, s, c, v = self._suppress(*candidates, conf)
                del candidates
            with span("unmap"):
                orig_boxes, v = self._unmap(b, v, h, w, area_scale)
            with span("crop"):
                crops = self._crop(frames, orig_boxes, v)
            with span("classify"):
                probs, v = self._classify_budgeted(crops, s, v, group)
                del crops
                labels = probs.argmax(dim=-1).to(torch.int32)
                cls_scores = probs.amax(dim=-1)
        return {
            "boxes": orig_boxes,
            "det_scores": s,
            "det_class_ids": c,
            "valid": v,
            "cls_probs": probs,
            "cls_labels": labels,
            "cls_scores": cls_scores,
        }

    # ------------------------------------------------------------------ #
    # staged programs                                                     #
    # ------------------------------------------------------------------ #

    @torch.inference_mode()
    def _detect_top(self, canvas01, k: int):
        """(B, S, S, 3) [0, 1] canvases in host colour order (numpy or
        tensor) -> the top ``k`` score-descending candidates (boxes (B, K,
        4) letterbox-space xyxy, scores (B, K), class_ids (B, K) int32),
        through the whole detector with its own stem."""
        x = torch.as_tensor(canvas01).to(device=self.device, dtype=self.dtype)
        if self.cfg.input_color == "bgr":
            x = x.flip(-1)  # the detector computes in RGB
        return self._candidates(self.det_model(self._det_input(x.permute(0, 3, 1, 2))), k)

    @_in_precision
    @torch.inference_mode()
    def detect(self, canvas01, conf_threshold: Optional[float] = None) -> Dict[str, torch.Tensor]:
        """Detector stage on pre-letterboxed [0, 1] canvases (B, S, S, 3):
        forward, decode, top ``max_candidates``, NMS (the NMS kernel on the
        card).  Returns boxes (B, D, 4) in letterbox space, scores,
        class_ids and valid, D = ``max_detections``; the caller
        un-letterboxes with its own per-image geometry."""
        conf = self.cfg.benchmark_conf if conf_threshold is None else conf_threshold
        nms_cfg = self.cfg.nms
        boxes, scores, class_ids = self._detect_top(canvas01, nms_cfg.max_candidates)
        b, s, c, v = nms_sorted(
            boxes, scores, class_ids, conf, nms_cfg.iou_threshold,
            nms_cfg.max_detections,
        )
        return {"boxes": b, "scores": s, "class_ids": c, "valid": v}

    @_in_precision
    def detect_candidates(self, canvas01, max_candidates: Optional[int] = None):
        """Decoded score-descending candidates without suppression, for a
        host-NMS evaluation pass: (boxes (B, K, 4) letterbox-space xyxy,
        scores (B, K), class_ids (B, K)) with K = ``max_candidates``, by
        default ``nms.eval_max_candidates``; 0 means every prediction, and
        K never exceeds ``candidate_capacity`` (the anchor count, or the
        decoder's)."""
        k = max_candidates or self.cfg.nms.eval_max_candidates
        cap = self._candidate_capacity
        return self._detect_top(canvas01, min(k, cap) if k else cap)

    @_in_precision
    @torch.inference_mode()
    def classify(self, crops01) -> torch.Tensor:
        """Classifier stage: (N, c, c, 3) crops in [0, 1], host colour order
        (numpy or tensor) -> (N, num_classes) float32 probabilities."""
        x = torch.as_tensor(crops01).to(device=self.device, dtype=torch.float32)
        return self._classify(x)
