"""Classifier evaluation: accuracy, macro P / R / F1, parameters, size, FPS
and single-image top-k.

The port's copy of the JAX package's ``bench/classifier_bench.py`` (after
the reference's ``evaluation-tsr.ipynb`` cells 6-16), over the port's
``build_classifier`` with Flax-named variable trees (``weights/
jax_bridge.py``).  FPS: ``timed_iters`` back-to-back forwards on one batch,
timed with CUDA events on the card (the host clock on the CPU), after
``warmup`` discarded runs.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def _leaves(tree: Any) -> Iterator[np.ndarray]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield np.asarray(tree)


def count_params(variables) -> int:
    return sum(int(np.prod(x.shape)) for x in _leaves(variables["params"]))


def model_size_mb(variables) -> float:
    return sum(x.size * x.dtype.itemsize for x in _leaves(variables)) / (1024 * 1024)


def macro_prf1(preds: np.ndarray, labels: np.ndarray, num_classes: int) -> Tuple[float, float, float]:
    """Macro precision, recall and F1 over the classes present in
    ``labels``."""
    eps = 1e-12
    ps, rs = [], []
    for c in range(num_classes):
        tp = int(((preds == c) & (labels == c)).sum())
        fp = int(((preds == c) & (labels != c)).sum())
        fn = int(((preds != c) & (labels == c)).sum())
        if tp + fn == 0:  # class absent from the labels: macro over present ones
            continue
        ps.append(tp / (tp + fp + eps))
        rs.append(tp / (tp + fn + eps))
    p = float(np.mean(ps)) if ps else 0.0
    r = float(np.mean(rs)) if rs else 0.0
    f1 = 2 * p * r / (p + r + 1e-12) if (p + r) else 0.0
    return p, r, f1


def _model(arch: str, variables, num_classes: int, device, dtype: torch.dtype):
    """The classifier of ``arch`` holding ``variables`` on ``device``; in
    bf16 its BatchNorm and ``fc`` stay float32, as the JAX models'."""
    from litepi_tpu_torch.models import build_classifier
    from litepi_tpu_torch.weights.jax_bridge import jax_to_state_dict

    model = build_classifier(arch, num_classes)
    model.load_state_dict(jax_to_state_dict(variables))
    model = model.eval().to(device=device, dtype=dtype)
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d) or name == "fc":
            m.float()
    return model


def evaluate_classifier(
    arch: str,
    variables,
    images: np.ndarray,
    labels: np.ndarray,
    num_classes: int,
    batch: int = 128,
    warmup: int = 2,
    timed_iters: int = 20,
    dtype: str = "float32",
    device="cuda",
) -> Dict[str, float]:
    """The reference's classifier report.  ``images`` (N, c, c, 3)
    normalised float32 NHWC; ``labels`` (N,).  Runs with TF32 off and gives
    the caller's flags back."""
    from litepi_tpu_torch.core.device import resolve_device
    from litepi_tpu_torch.weights.graph_ops import tf32_off

    dev = resolve_device(device)
    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    model = _model(arch, variables, num_classes, dev, tdtype)

    def fwd(x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x)).to(dev).permute(0, 3, 1, 2)
        return model(t.to(tdtype)).float()

    n = len(images)
    preds = np.zeros(n, np.int64)
    pad_n = int(np.ceil(n / batch) * batch)
    padded = np.concatenate([images, np.zeros((pad_n - n, *images.shape[1:]), images.dtype)])
    with tf32_off(), torch.inference_mode():
        for i in range(0, pad_n, batch):
            logits = fwd(padded[i: i + batch]).cpu().numpy()
            preds[i: min(i + batch, n)] = logits.argmax(-1)[: max(0, min(batch, n - i))]
        acc = float((preds == labels).mean())
        p, r, f1 = macro_prf1(preds, labels, num_classes)

        bench = torch.from_numpy(np.ascontiguousarray(padded[:batch])).to(dev)
        bench = bench.permute(0, 3, 1, 2).to(tdtype)
        for _ in range(max(warmup, 1)):
            for _ in range(timed_iters):
                model(bench)
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            for _ in range(timed_iters):
                model(bench)
            end.record()
            torch.cuda.synchronize(dev)
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(timed_iters):
                model(bench)
            dt = time.perf_counter() - t0
    return {
        "model": arch,
        "accuracy": acc,
        "precision_macro": p,
        "recall_macro": r,
        "f1_macro": f1,
        "params": count_params(variables),
        "size_mb": round(model_size_mb(variables), 2),
        "fps": round(batch * timed_iters / dt, 1),
        "batch": batch,
    }


def confusion_matrix(preds: np.ndarray, labels: np.ndarray, num_classes: int) -> np.ndarray:
    """(num_classes, num_classes) counts, rows the true class, columns the
    predicted one."""
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (labels.astype(np.int64), preds.astype(np.int64)), 1)
    return cm


def confusion_analysis(
    preds: np.ndarray,
    labels: np.ndarray,
    num_classes: int,
    top: int = 10,
    class_names: Optional[Dict[int, str]] = None,
) -> Dict:
    """The reference's per-class error report: the most-confused (true ->
    predicted) pairs and the worst per-class accuracies of the classes
    present in the labels."""
    cm = confusion_matrix(preds, labels, num_classes)
    off = cm.copy()
    np.fill_diagonal(off, 0)

    def name(c: int) -> str:
        return class_names.get(c, str(c)) if class_names else str(c)

    pairs = []
    for idx in np.argsort(-off, axis=None)[:top]:  # descending: the first 0 ends it
        t, pcl = divmod(int(idx), num_classes)
        if off[t, pcl] == 0:
            break
        pairs.append({"true": name(t), "pred": name(pcl), "count": int(off[t, pcl])})
    support = cm.sum(axis=1)
    per_class = {name(int(c)): float(cm[c, c] / support[c]) for c in np.nonzero(support)[0]}
    worst = sorted(per_class.items(), key=lambda kv: kv[1])[:top]
    return {"confusion_matrix": cm, "most_confused": pairs, "per_class_accuracy": per_class,
            "worst_classes": worst}


def predict_topk(
    arch: str,
    variables,
    image: np.ndarray,
    num_classes: int,
    k: int = 5,
    class_names: Optional[Dict[int, str]] = None,
    device="cuda",
):
    """Single-image top-k: ``image`` (c, c, 3) normalised float32 ->
    [{class_id, class_name, prob}] by descending probability."""
    from litepi_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    model = _model(arch, variables, num_classes, dev, torch.float32)
    with torch.inference_mode():
        x = torch.from_numpy(np.ascontiguousarray(image[None])).to(dev).permute(0, 3, 1, 2)
        logits = model(x).float().cpu().numpy()[0]
    probs = np.exp(logits - logits.max())
    probs /= probs.sum()
    return [
        {"class_id": int(c),
         "class_name": class_names.get(int(c), str(int(c))) if class_names else str(int(c)),
         "prob": float(probs[c])}
        for c in np.argsort(-probs)[:k]
    ]
