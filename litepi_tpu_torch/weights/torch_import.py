"""torch/torchvision ``.pth`` and Ultralytics ``.pt`` -> Flax-named variables.

The port's copy of the JAX package's ``weights/torch_import.py``.  It
returns numpy variable trees with the Flax names (``{"params": ...,
"batch_stats": ...}``), as the JAX importer does, so the one name mapping
into the port's modules stays ``weights/jax_bridge.py``
(``TwoStagePipeline.from_jax_vars``).  The conversion is a key mapping
plus layout transposes:

* conv weight (O, I, kh, kw) -> kernel (kh, kw, I, O)
* depthwise conv (O, 1, kh, kw) -> kernel (kh, kw, 1, O)  (same transpose)
* linear (O, I) -> kernel (I, O)
* BatchNorm weight/bias -> params scale/bias; running stats -> batch_stats

Converters take a ``{key: numpy array}`` dict so unpickling stays at the
caller (see :func:`load_torch_state_dict`).  An Ultralytics training
container unpickles through a stub unpickler that resolves only an
allowlist of exact symbols (:func:`load_ultralytics_container`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np

Tree = Dict[str, Any]


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a ``.pth`` file into plain numpy arrays (CPU).

    Falls back to the lenient Ultralytics-container loader when the file is
    not a plain state dict (``weights_only`` unpicklable, or a training
    container with a ``model`` attribute)."""
    import torch

    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except FileNotFoundError:
        raise
    except Exception:
        # not a plain-tensor pickle: fall back to the CONTAINER loader,
        # whose unpickler only resolves an exact-symbol allowlist (see
        # _LenientUnpickler) — the fallback never re-enables arbitrary
        # pickle execution
        return load_ultralytics_container(path)
    state = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    out = {
        k: v.detach().numpy() for k, v in state.items() if hasattr(v, "numpy")
    }
    if not out:
        return load_ultralytics_container(path)
    return out


class _StubModule:
    """Stand-in for unimportable classes (e.g. ultralytics.nn.tasks.*) during
    lenient unpickling.  Pickled ``nn.Module`` objects restore through
    ``__setstate__``/``__dict__`` updates, which this accepts verbatim."""

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple):  # (state, slots) protocol
            for part in state:
                if isinstance(part, dict):
                    self.__dict__.update(part)


def _collect_module_tensors(obj, prefix: str = "") -> Dict[str, np.ndarray]:
    """Walk an (possibly stubbed) ``nn.Module`` object graph, collecting
    parameters and buffers into a dotted-name state dict — exactly what
    ``Module.state_dict()`` would have produced."""
    out: Dict[str, np.ndarray] = {}
    d = getattr(obj, "__dict__", None)
    if not isinstance(d, dict):
        return out
    for store in ("_parameters", "_buffers"):
        for name, t in (d.get(store) or {}).items():
            if t is not None and hasattr(t, "detach"):
                out[prefix + name] = (
                    t.detach().to("cpu").float().numpy()
                )
    for name, child in (d.get("_modules") or {}).items():
        if child is not None:
            out.update(_collect_module_tensors(child, f"{prefix}{name}."))
    return out


def load_ultralytics_container(path: str) -> Dict[str, np.ndarray]:
    """Unwrap an Ultralytics training checkpoint (``best.pt``/``last.pt``)
    into a numpy state dict WITHOUT the ultralytics package installed.

    The container is a torch pickle ``{'model': DetectionModel, 'ema': ...,
    'epoch': ...}`` (the artifact the reference's training notebooks emit and
    its converters consume — src/tt100k/convert/model/*/).  Unpickling the
    ``DetectionModel`` normally requires ultralytics classes; here a lenient
    unpickler substitutes inert stubs for any unimportable class, then the
    module graph is walked for its parameters/buffers (fp16 weights are
    upcast to float32).  Prefers the EMA weights when present, as
    Ultralytics' own loader does.
    """
    import pickle
    import types

    import torch

    # Only EXACT symbols may resolve to real objects during unpickling;
    # everything else — importable or not — becomes an inert stub.  Whole
    # package prefixes are not safe: even "trusted" trees contain exec
    # gadgets (e.g. numpy.testing._private.utils.runstring).  We mirror
    # torch.load(weights_only=True)'s own allowlist (the tensor-rebuild
    # machinery, storages, dtypes) and add the handful of numpy /
    # collections symbols the Ultralytics container format actually needs.
    safe_globals: Dict[str, Any] = {}
    try:  # torch's own weights_only allowlist — exact, maintained upstream
        import torch._weights_only_unpickler as _wou

        safe_globals.update(_wou._get_allowed_globals())
    except Exception:  # pragma: no cover - older torch: minimal hand list
        import collections

        safe_globals.update({
            "collections.OrderedDict": collections.OrderedDict,
            "torch._utils._rebuild_tensor": torch._utils._rebuild_tensor,
            "torch._utils._rebuild_tensor_v2":
                torch._utils._rebuild_tensor_v2,
            "torch._utils._rebuild_parameter":
                torch._utils._rebuild_parameter,
            "torch.Size": torch.Size,
            "torch.device": torch.device,
            "torch.nn.parameter.Parameter": torch.nn.Parameter,
        })
        for _n in dir(torch):
            if _n.endswith("Storage") or isinstance(
                getattr(torch, _n, None), torch.dtype
            ):
                safe_globals[f"torch.{_n}"] = getattr(torch, _n)
    for _mod in ("numpy.core.multiarray", "numpy._core.multiarray"):
        try:
            _m = __import__(_mod, fromlist=["_reconstruct"])
            safe_globals[f"{_mod}._reconstruct"] = _m._reconstruct
            safe_globals[f"{_mod}.scalar"] = _m.scalar
        except (ImportError, AttributeError):
            pass
    safe_globals["numpy.ndarray"] = np.ndarray
    safe_globals["numpy.dtype"] = np.dtype

    class _LenientUnpickler(pickle.Unpickler):
        def find_class(self, module, name):  # noqa: D102
            if module == "__builtin__":  # legacy py2 name torch emits
                module = "builtins"
            hit = safe_globals.get(f"{module}.{name}")
            if hit is not None:
                return hit
            return type(name, (_StubModule,), {"__module__": module})

    pickle_module = types.SimpleNamespace(
        Unpickler=_LenientUnpickler, load=None, __name__="lenient_pickle"
    )
    obj = torch.load(
        path, map_location="cpu", pickle_module=pickle_module,
        weights_only=False,
    )

    model = obj
    if isinstance(obj, dict):
        model = obj.get("ema") or obj.get("model") or obj
    if isinstance(model, dict):  # already a state dict
        return {
            k: v.detach().float().numpy()
            for k, v in model.items()
            if hasattr(v, "detach")
        }
    sd = _collect_module_tensors(model)
    if not sd:
        raise ValueError(
            f"{path}: found no tensors — not a state dict or module container"
        )
    return sd


def _conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def _set(tree: Tree, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.ascontiguousarray(value)


def _put_conv(params: Tree, dst: Tuple[str, ...], sd: Mapping, src: str) -> None:
    _set(params, dst + ("kernel",), _conv(sd[f"{src}.weight"]))
    if f"{src}.bias" in sd:
        _set(params, dst + ("bias",), sd[f"{src}.bias"])


def _put_bn(
    params: Tree, stats: Tree, dst: Tuple[str, ...], sd: Mapping, src: str
) -> None:
    _set(params, dst + ("scale",), sd[f"{src}.weight"])
    _set(params, dst + ("bias",), sd[f"{src}.bias"])
    _set(stats, dst + ("mean",), sd[f"{src}.running_mean"])
    _set(stats, dst + ("var",), sd[f"{src}.running_var"])


def _put_linear(params: Tree, dst: Tuple[str, ...], sd: Mapping, src: str) -> None:
    _set(params, dst + ("kernel",), sd[f"{src}.weight"].T)
    if f"{src}.bias" in sd:
        _set(params, dst + ("bias",), sd[f"{src}.bias"])


def _convert_shufflenetv2(
    sd: Mapping[str, np.ndarray], stage_repeats=(4, 8, 4)
) -> Tree:
    p: Tree = {}
    s: Tree = {}
    _put_conv(p, ("conv1", "conv"), sd, "conv1.0")
    _put_bn(p, s, ("conv1", "bn"), sd, "conv1.1")
    for stage, reps in zip((2, 3, 4), stage_repeats):
        for i in range(reps):
            t = f"stage{stage}.{i}"
            f = f"stage{stage}_{i}"
            if i == 0:  # stride-2 unit has branch1
                _put_conv(p, (f, "b1_dw", "conv"), sd, f"{t}.branch1.0")
                _put_bn(p, s, (f, "b1_dw", "bn"), sd, f"{t}.branch1.1")
                _put_conv(p, (f, "b1_pw", "conv"), sd, f"{t}.branch1.2")
                _put_bn(p, s, (f, "b1_pw", "bn"), sd, f"{t}.branch1.3")
            _put_conv(p, (f, "b2_pw1", "conv"), sd, f"{t}.branch2.0")
            _put_bn(p, s, (f, "b2_pw1", "bn"), sd, f"{t}.branch2.1")
            _put_conv(p, (f, "b2_dw", "conv"), sd, f"{t}.branch2.3")
            _put_bn(p, s, (f, "b2_dw", "bn"), sd, f"{t}.branch2.4")
            _put_conv(p, (f, "b2_pw2", "conv"), sd, f"{t}.branch2.5")
            _put_bn(p, s, (f, "b2_pw2", "bn"), sd, f"{t}.branch2.6")
    _put_conv(p, ("conv5", "conv"), sd, "conv5.0")
    _put_bn(p, s, ("conv5", "bn"), sd, "conv5.1")
    _put_linear(p, ("fc",), sd, "fc")
    return {"params": p, "batch_stats": s}


def _convert_resnet18(sd: Mapping[str, np.ndarray], stage_sizes=(2, 2, 2, 2)) -> Tree:
    p: Tree = {}
    s: Tree = {}
    _put_conv(p, ("conv1",), sd, "conv1")
    _put_bn(p, s, ("bn1",), sd, "bn1")
    for layer, blocks in enumerate(stage_sizes, start=1):
        for i in range(blocks):
            t = f"layer{layer}.{i}"
            f = f"layer{layer}_{i}"
            _put_conv(p, (f, "cb1", "conv"), sd, f"{t}.conv1")
            _put_bn(p, s, (f, "cb1", "bn"), sd, f"{t}.bn1")
            _put_conv(p, (f, "cb2", "conv"), sd, f"{t}.conv2")
            _put_bn(p, s, (f, "cb2", "bn"), sd, f"{t}.bn2")
            if f"{t}.downsample.0.weight" in sd:
                _put_conv(p, (f, "down", "conv"), sd, f"{t}.downsample.0")
                _put_bn(p, s, (f, "down", "bn"), sd, f"{t}.downsample.1")
    _put_linear(p, ("fc",), sd, "fc")
    return {"params": p, "batch_stats": s}


def _convert_mobilenetv2(sd: Mapping[str, np.ndarray]) -> Tree:
    from litepi_tpu_torch.models.mobilenetv2 import _V2_SETTINGS

    p: Tree = {}
    s: Tree = {}
    _put_conv(p, ("stem", "conv"), sd, "features.0.0")
    _put_bn(p, s, ("stem", "bn"), sd, "features.0.1")
    feat = 1
    idx = 0
    for t, _, n, _ in _V2_SETTINGS:
        for _ in range(n):
            f = f"block{idx}"
            src = f"features.{feat}"
            if t == 1:  # no expand conv: conv.0=dw ConvBNReLU, conv.1/2=pw-linear
                _put_conv(p, (f, "dw", "conv"), sd, f"{src}.conv.0.0")
                _put_bn(p, s, (f, "dw", "bn"), sd, f"{src}.conv.0.1")
                _put_conv(p, (f, "pw_linear", "conv"), sd, f"{src}.conv.1")
                _put_bn(p, s, (f, "pw_linear", "bn"), sd, f"{src}.conv.2")
            else:
                _put_conv(p, (f, "pw", "conv"), sd, f"{src}.conv.0.0")
                _put_bn(p, s, (f, "pw", "bn"), sd, f"{src}.conv.0.1")
                _put_conv(p, (f, "dw", "conv"), sd, f"{src}.conv.1.0")
                _put_bn(p, s, (f, "dw", "bn"), sd, f"{src}.conv.1.1")
                _put_conv(p, (f, "pw_linear", "conv"), sd, f"{src}.conv.2")
                _put_bn(p, s, (f, "pw_linear", "bn"), sd, f"{src}.conv.3")
            feat += 1
            idx += 1
    _put_conv(p, ("head_conv", "conv"), sd, f"features.{feat}.0")
    _put_bn(p, s, ("head_conv", "bn"), sd, f"features.{feat}.1")
    _put_linear(p, ("fc",), sd, "classifier.1")
    return {"params": p, "batch_stats": s}


def _convert_efficientnet_b0(sd: Mapping[str, np.ndarray]) -> Tree:
    from litepi_tpu_torch.models.efficientnet import _B0_SETTINGS

    p: Tree = {}
    s: Tree = {}
    _put_conv(p, ("stem", "conv"), sd, "features.0.0")
    _put_bn(p, s, ("stem", "bn"), sd, "features.0.1")
    idx = 0
    for stage, (t, _, n, _, _) in enumerate(_B0_SETTINGS, start=1):
        for i in range(n):
            f = f"block{idx}"
            src = f"features.{stage}.{i}.block"
            if t == 1:  # stage 1: dw, se, pw-linear
                parts = [("dw", 0), ("se", 1), ("pw_linear", 2)]
            else:
                parts = [("pw", 0), ("dw", 1), ("se", 2), ("pw_linear", 3)]
            for name, j in parts:
                if name == "se":
                    _put_conv(p, (f, "se", "fc1"), sd, f"{src}.{j}.fc1")
                    _put_conv(p, (f, "se", "fc2"), sd, f"{src}.{j}.fc2")
                else:
                    _put_conv(p, (f, name, "conv"), sd, f"{src}.{j}.0")
                    _put_bn(p, s, (f, name, "bn"), sd, f"{src}.{j}.1")
            idx += 1
    _put_conv(p, ("head_conv", "conv"), sd, "features.8.0")
    _put_bn(p, s, ("head_conv", "bn"), sd, "features.8.1")
    _put_linear(p, ("fc",), sd, "classifier.1")
    return {"params": p, "batch_stats": s}


_CONVERTERS = {
    "shufflenetv2": _convert_shufflenetv2,
    "resnet18": _convert_resnet18,
    "mobilenetv2": _convert_mobilenetv2,
    "efficientnet": _convert_efficientnet_b0,
}


def convert_detector_state_dict(
    sd: Mapping[str, np.ndarray], depths=(1, 2, 2, 1)
) -> Tree:
    """Ultralytics-keyed YOLOv8-family state dict -> YoloLitePi
    variables.

    The reference's detectors train through Ultralytics and export as
    ``model.{idx}.*`` module lists (train-yolo-custom-tt100k.ipynb); this maps
    that layout (backbone 0-9, PAN 10-21, Detect 22 with cv2=box / cv3=cls
    branches) onto the Flax module names.  The DFL expectation conv
    (model.22.dfl) is a constant [0..reg_max) — litepi computes it in
    ops/dfl.py, so it is skipped.
    """
    p: Tree = {}
    s: Tree = {}

    def conv_bn(dst: Tuple[str, ...], src: str) -> None:
        _put_conv(p, dst + ("conv",), sd, f"{src}.conv")
        _put_bn(p, s, dst + ("bn",), sd, f"{src}.bn")

    def c2f(dst: Tuple[str, ...], src: str, n: int) -> None:
        conv_bn(dst + ("cv1",), f"{src}.cv1")
        conv_bn(dst + ("cv2",), f"{src}.cv2")
        for i in range(n):
            conv_bn(dst + (f"m{i}", "cv1"), f"{src}.m.{i}.cv1")
            conv_bn(dst + (f"m{i}", "cv2"), f"{src}.m.{i}.cv2")

    bb = ("backbone",)
    conv_bn(bb + ("stem",), "model.0")
    conv_bn(bb + ("down1",), "model.1")
    c2f(bb + ("c2f1",), "model.2", depths[0])
    conv_bn(bb + ("down2",), "model.3")
    c2f(bb + ("c2f2",), "model.4", depths[1])
    conv_bn(bb + ("down3",), "model.5")
    c2f(bb + ("c2f3",), "model.6", depths[2])
    conv_bn(bb + ("down4",), "model.7")
    c2f(bb + ("c2f4",), "model.8", depths[3])
    conv_bn(bb + ("sppf", "cv1"), "model.9.cv1")
    conv_bn(bb + ("sppf", "cv2"), "model.9.cv2")

    nk = ("neck",)
    c2f(nk + ("td_p4",), "model.12", depths[0])
    c2f(nk + ("td_p3",), "model.15", depths[0])
    conv_bn(nk + ("bu_down3",), "model.16")
    c2f(nk + ("bu_p4",), "model.18", depths[0])
    conv_bn(nk + ("bu_down4",), "model.19")
    c2f(nk + ("bu_p5",), "model.21", depths[0])

    hd = ("head",)
    for i in range(3):
        conv_bn(hd + (f"reg{i}_cv1",), f"model.22.cv2.{i}.0")
        conv_bn(hd + (f"reg{i}_cv2",), f"model.22.cv2.{i}.1")
        _put_conv(p, hd + (f"reg{i}_out",), sd, f"model.22.cv2.{i}.2")
        conv_bn(hd + (f"cls{i}_cv1",), f"model.22.cv3.{i}.0")
        conv_bn(hd + (f"cls{i}_cv2",), f"model.22.cv3.{i}.1")
        _put_conv(p, hd + (f"cls{i}_out",), sd, f"model.22.cv3.{i}.2")

    return {"params": p, "batch_stats": s}


def convert_yolov5u_state_dict(sd: Mapping[str, np.ndarray]) -> Tree:
    """Ultralytics yolov5nu state dict -> YoloV5(anchor_free)
    variables.

    The deployed 'yolo5' is the u-variant (v5 body, v8 DFL head at
    model.24 — src/*/convert/model/yolo5/yolo5_ncnn_model/model.ncnn.param);
    this maps its module list (backbone 0-9, PAN 10-23, Detect 24) onto
    the Flax names of models/yolov5.py.  model.24.dfl is skipped (litepi
    computes the DFL expectation in ops/dfl.py)."""
    p: Tree = {}
    s: Tree = {}

    def conv_bn(dst: Tuple[str, ...], src: str) -> None:
        _put_conv(p, dst + ("conv",), sd, f"{src}.conv")
        _put_bn(p, s, dst + ("bn",), sd, f"{src}.bn")

    def c3(dst: Tuple[str, ...], src: str, n: int) -> None:
        conv_bn(dst + ("cv1",), f"{src}.cv1")
        conv_bn(dst + ("cv2",), f"{src}.cv2")
        conv_bn(dst + ("cv3",), f"{src}.cv3")
        for i in range(n):
            conv_bn(dst + (f"m{i}", "cv1"), f"{src}.m.{i}.cv1")
            conv_bn(dst + (f"m{i}", "cv2"), f"{src}.m.{i}.cv2")

    conv_bn(("stem",), "model.0")
    conv_bn(("down1",), "model.1")
    c3(("c3_1",), "model.2", 1)
    conv_bn(("down2",), "model.3")
    c3(("c3_2",), "model.4", 2)
    conv_bn(("down3",), "model.5")
    c3(("c3_3",), "model.6", 3)
    conv_bn(("down4",), "model.7")
    c3(("c3_4",), "model.8", 1)
    conv_bn(("sppf", "cv1"), "model.9.cv1")
    conv_bn(("sppf", "cv2"), "model.9.cv2")
    conv_bn(("td_cv5",), "model.10")
    c3(("td_p4",), "model.13", 1)
    conv_bn(("td_cv4",), "model.14")
    c3(("td_p3",), "model.17", 1)
    conv_bn(("bu_down3",), "model.18")
    c3(("bu_p4",), "model.20", 1)
    conv_bn(("bu_down4",), "model.21")
    c3(("bu_p5",), "model.23", 1)
    for i in range(3):
        conv_bn((f"reg{i}_cv1",), f"model.24.cv2.{i}.0")
        conv_bn((f"reg{i}_cv2",), f"model.24.cv2.{i}.1")
        _put_conv(p, (f"reg{i}_out",), sd, f"model.24.cv2.{i}.2")
        conv_bn((f"cls{i}_cv1",), f"model.24.cv3.{i}.0")
        conv_bn((f"cls{i}_cv2",), f"model.24.cv3.{i}.1")
        _put_conv(p, (f"cls{i}_out",), sd, f"model.24.cv3.{i}.2")
    return {"params": p, "batch_stats": s}


def _qkv_permutation(
    num_heads: int, key_dim: int, head_dim: int
) -> np.ndarray:
    """Channel permutation taking Ultralytics' Attention qkv layout to
    ours.

    torch packs the qkv conv's output heads-major — per head
    ``[q(key_dim), k(key_dim), v(head_dim)]`` (Attention.forward views
    (b, nh, 2*kd+hd, n) then splits dim 2); models/yolov11.py splits
    branch-major — ``[q all heads | k all heads | v all heads]`` with
    (nh, dim) interleave inside each branch.  Returns ``idx`` such that
    ``ours_channel[i] = torch_channel[idx[i]]``."""
    per_head = 2 * key_dim + head_dim
    idx = []
    for off, size in ((0, key_dim), (key_dim, key_dim), (2 * key_dim, head_dim)):
        for h in range(num_heads):
            base = h * per_head + off
            idx.extend(range(base, base + size))
    return np.asarray(idx)


def convert_yolov11_state_dict(sd: Mapping[str, np.ndarray]) -> Tree:
    """Ultralytics yolov11n state dict -> YoloV11 variables.

    Maps the module list of the deployed v11n export (backbone 0-10 incl.
    C2PSA, PAN 11-22, Detect 23 with the depthwise-separable cls branch —
    src/*/convert/model/yolo11/yolo11_ncnn_model/model.ncnn.param) onto
    models/yolov11.py.  The attention qkv conv's output channels are
    re-ordered from torch's heads-major packing to our branch-major
    split (see :func:`_qkv_permutation`); model.23.dfl is skipped."""
    p: Tree = {}
    s: Tree = {}

    def conv_bn(dst: Tuple[str, ...], src: str) -> None:
        _put_conv(p, dst + ("conv",), sd, f"{src}.conv")
        _put_bn(p, s, dst + ("bn",), sd, f"{src}.bn")

    def c3k2(dst: Tuple[str, ...], src: str, n: int, c3k: bool) -> None:
        conv_bn(dst + ("cv1",), f"{src}.cv1")
        conv_bn(dst + ("cv2",), f"{src}.cv2")
        for i in range(n):
            d2, s2 = dst + (f"m{i}",), f"{src}.m.{i}"
            if c3k:
                conv_bn(d2 + ("cv1",), f"{s2}.cv1")
                conv_bn(d2 + ("cv2",), f"{s2}.cv2")
                conv_bn(d2 + ("cv3",), f"{s2}.cv3")
                for j in range(2):
                    conv_bn(d2 + (f"m{j}", "cv1"), f"{s2}.m.{j}.cv1")
                    conv_bn(d2 + (f"m{j}", "cv2"), f"{s2}.m.{j}.cv2")
            else:
                conv_bn(d2 + ("cv1",), f"{s2}.cv1")
                conv_bn(d2 + ("cv2",), f"{s2}.cv2")

    conv_bn(("stem",), "model.0")
    conv_bn(("down1",), "model.1")
    c3k2(("c3k2_1",), "model.2", 1, False)
    conv_bn(("down2",), "model.3")
    c3k2(("c3k2_2",), "model.4", 1, False)
    conv_bn(("down3",), "model.5")
    c3k2(("c3k2_3",), "model.6", 1, True)
    conv_bn(("down4",), "model.7")
    c3k2(("c3k2_4",), "model.8", 1, True)
    conv_bn(("sppf", "cv1"), "model.9.cv1")
    conv_bn(("sppf", "cv2"), "model.9.cv2")

    conv_bn(("c2psa", "cv1"), "model.10.cv1")
    attn = ("c2psa", "m0", "attn")
    dim = sd["model.10.m.0.attn.proj.conv.weight"].shape[0]
    nh = max(dim // 64, 1)
    head_dim = dim // nh
    perm = _qkv_permutation(nh, head_dim // 2, head_dim)
    qsrc = "model.10.m.0.attn.qkv"
    _set(p, attn + ("qkv", "conv", "kernel"),
         _conv(sd[f"{qsrc}.conv.weight"][perm]))
    _set(p, attn + ("qkv", "bn", "scale"), sd[f"{qsrc}.bn.weight"][perm])
    _set(p, attn + ("qkv", "bn", "bias"), sd[f"{qsrc}.bn.bias"][perm])
    _set(s, attn + ("qkv", "bn", "mean"), sd[f"{qsrc}.bn.running_mean"][perm])
    _set(s, attn + ("qkv", "bn", "var"), sd[f"{qsrc}.bn.running_var"][perm])
    conv_bn(attn + ("pe",), "model.10.m.0.attn.pe")
    conv_bn(attn + ("proj",), "model.10.m.0.attn.proj")
    conv_bn(("c2psa", "m0", "ffn1"), "model.10.m.0.ffn.0")
    conv_bn(("c2psa", "m0", "ffn2"), "model.10.m.0.ffn.1")
    conv_bn(("c2psa", "cv2"), "model.10.cv2")

    c3k2(("td_p4",), "model.13", 1, False)
    c3k2(("td_p3",), "model.16", 1, False)
    conv_bn(("bu_down3",), "model.17")
    c3k2(("bu_p4",), "model.19", 1, False)
    conv_bn(("bu_down4",), "model.20")
    c3k2(("bu_p5",), "model.22", 1, True)
    for i in range(3):
        conv_bn((f"reg{i}_cv1",), f"model.23.cv2.{i}.0")
        conv_bn((f"reg{i}_cv2",), f"model.23.cv2.{i}.1")
        _put_conv(p, (f"reg{i}_out",), sd, f"model.23.cv2.{i}.2")
        conv_bn((f"cls{i}_dw1",), f"model.23.cv3.{i}.0.0")
        conv_bn((f"cls{i}_pw1",), f"model.23.cv3.{i}.0.1")
        conv_bn((f"cls{i}_dw2",), f"model.23.cv3.{i}.1.0")
        conv_bn((f"cls{i}_pw2",), f"model.23.cv3.{i}.1.1")
        _put_conv(p, (f"cls{i}_out",), sd, f"model.23.cv3.{i}.2")
    return {"params": p, "batch_stats": s}


def convert_classifier_state_dict(
    arch: str, state_dict: Mapping[str, np.ndarray]
) -> Tree:
    """Convert a torchvision-style state dict (as numpy) into Flax variables
    ``{"params": ..., "batch_stats": ...}`` for the matching classifier.
    """
    if arch not in _CONVERTERS:
        raise ValueError(f"no converter for arch {arch!r}; choices: {sorted(_CONVERTERS)}")
    return _CONVERTERS[arch](state_dict)
