"""Layer-by-layer bf16 comparison of the zoo's nets, port against JAX.

For a net of the zoo (YOLOv11n, YOLOv5n in both heads, ResNet18,
MobileNetV2), the
same variables and the same bf16-exact input go through the JAX model in
float32 and in bfloat16 (flax ``capture_intermediates``) and through the
port's model in bfloat16 as its pipeline places it (forward hooks).  For
every module output both sides have, in the port's execution order:

* ``port``: ``max |port_bf16 - jax_bf16|``, the port's difference;
* ``drift``: ``max |jax_bf16 - jax_f32|``, JAX's own bf16 drift;
* the share of elements where the two bf16 outputs differ.

:func:`first_outside` gives the first module whose difference exceeds the
drift.  :func:`op_checks` feeds single ops one identical bf16 input on
both sides, to name the op that rounds otherwise.  Run::

    JAX_PLATFORMS=cpu python -m tests.torch_bf16_layers [yolov11n yolov5n yolov5n_legacy resnet18 mobilenetv2]
    JAX_PLATFORMS=cpu python -m tests.torch_bf16_layers --pairs

The first prints the first rows of each table, the first module outside
and the op checks; ``--inject`` feeds each module of MobileNetV2 and of
the anchor-free YOLOv5n's backbone JAX's own bf16 input (with and without a
trial rounding) and runs YOLOv5n-u with JAX's stem output in place of the
port's; ``--pairs`` prints the ratios of the port's difference to its
bound for each zoo pair and for the default pair (yolo_plus + ShuffleNetV2,
tests/test_torch_bf16_parity.py), as the port rounds and in two trials:
every bf16 SiLU and sigmoid rounded once, as torch's ``F.silu`` and
``torch.sigmoid`` round (the port rounds each step, ``ops/act.py``), and
every fused bf16 ``ConvBN`` adding its bias apart
(``layers.py::conv_bias_apart``; the port does so in ResNet18 and
EfficientNet-B0 only).
The weights and inputs are tests/test_torch_bf16_zoo_parity.py's.
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from litepi_tpu.models import build_classifier as jax_build_classifier
from litepi_tpu.models.init_utils import fast_init
from litepi_tpu.models.registry import CLASSIFIER_BN_EPS
from litepi_tpu.models.yolov5 import YoloV5 as JaxYoloV5
from litepi_tpu.models.yolov11 import YoloV11 as JaxYoloV11
from litepi_tpu.weights.fold_bn import fold_pipeline_vars
from tests.torch_port_helpers import peaked_frames, perturb_batchnorm

NETS = ("yolov11n", "yolov5n", "yolov5n_legacy", "resnet18", "mobilenetv2")
CLASSIFIERS = ("resnet18", "mobilenetv2", "efficientnet")


def _jax_model(net, dtype, fused=False):
    if net == "yolov11n":
        return JaxYoloV11(num_classes=1, dtype=dtype)
    if net in ("yolov5n", "yolov5n_legacy"):
        return JaxYoloV5(anchor_free=net == "yolov5n", dtype=dtype)
    return jax_build_classifier(net, 10, dtype=dtype, fused=fused)


def setup(net):
    """((JAX variables, fused) as the JAX pipeline holds them, the port's
    module placed as its bf16 pipeline places it, a bf16-exact input
    (N, S, S, 3) float32): a detector's on the letterboxed peaked scene x
    1/255, a classifier's (folded, as both pipelines fold it) on
    normalised random crops."""
    from types import SimpleNamespace

    from litepi_tpu.ops.letterbox import letterbox_device
    from litepi_tpu_torch.core.types import YOLOV8N, PipelineConfig
    from litepi_tpu_torch.models import build_classifier, detector_kwargs
    from litepi_tpu_torch.models.layers import CLASSIFIER_BN_EPS as PORT_EPS
    from litepi_tpu_torch.pipeline import TwoStagePipeline
    from litepi_tpu_torch.weights.fold_bn import fold_pipeline_state
    from litepi_tpu_torch.weights.jax_bridge import jax_to_state_dict

    place = SimpleNamespace(device=torch.device("cpu"), dtype=torch.bfloat16)
    if net in CLASSIFIERS:
        clf = perturb_batchnorm(fast_init(jax_build_classifier(net, 10), seed=3, spatial=64),
                                seed=4, spread=0.05)
        state = fold_pipeline_state(jax_to_state_dict(clf), PORT_EPS)
        module = TwoStagePipeline._place(place, build_classifier(net, 10, fused=True), state,
                                         float32=("fc",))
        x = np.random.default_rng(4).uniform(0, 1, (8, 64, 64, 3)).astype(np.float32)
        return fold_pipeline_vars(clf, eps=CLASSIFIER_BN_EPS), module, (x - 0.18) / 0.34
    seed = {"yolov11n": 1, "yolov5n": 3, "yolov5n_legacy": 4}[net]
    det = perturb_batchnorm(fast_init(_jax_model(net, jnp.float32), seed=seed), seed=seed + 1)
    cfg = PipelineConfig(detector=YOLOV8N, det_input_size=160)
    model = detector_kwargs(net, cfg, "cpu")["det_model"]
    module = TwoStagePipeline._place(place, model, jax_to_state_dict(det))
    canvas = letterbox_device(peaked_frames(), 160, jnp.bfloat16)
    x = np.asarray((canvas * (1.0 / 255.0)).astype(jnp.bfloat16), np.float32)
    return (det, False), module, x


def jax_outputs(net, variables, fused, x, dtype):
    """{module path: output} of the JAX model in ``dtype`` (float32 numpy,
    NCHW for 4-D outputs)."""
    model = _jax_model(net, dtype, fused)
    _, state = model.apply(variables, jnp.asarray(x), train=False,
                           capture_intermediates=True, mutable=["intermediates"])
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if k == "__call__":
                a = v[0]
                if isinstance(a, dict) or not hasattr(a, "shape"):
                    continue
                a = np.asarray(a, np.float32)
                out[".".join(path)] = a.transpose(0, 3, 1, 2) if a.ndim == 4 else a
            elif isinstance(v, dict):
                walk(v, path + (k,))

    walk(state["intermediates"], ())
    return out


def port_outputs(module, x):
    """{module name: output} of the port's module (float32 numpy), in
    execution order."""
    out = {}
    hooks = [m.register_forward_hook(
        lambda m, i, o, name=name: out.__setitem__(name, o.float().numpy())
        if isinstance(o, torch.Tensor) else None)
        for name, m in module.named_modules() if name]
    try:
        with torch.inference_mode():
            module(torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16))
    finally:
        for h in hooks:
            h.remove()
    return out


def layer_table(net):
    """[(name, port difference, JAX drift, share of elements that differ)]
    in the port's execution order, for the module outputs that hold the
    same tensor on both sides (a flax ConvBN of ResNet18 returns before
    its block's ReLU, the port's after it: such rows, whose difference
    exceeds 50 times the drift, are left out)."""
    (variables, fused), module, x = setup(net)
    j32 = jax_outputs(net, variables, fused, x, jnp.float32)
    j16 = jax_outputs(net, variables, fused, x, jnp.bfloat16)
    p16 = port_outputs(module, x)
    rows = []
    for name, p in p16.items():
        if name not in j16 or j16[name].shape != p.shape:
            continue
        w, r = j16[name], j32[name]
        port, drift = float(np.abs(p - w).max()), float(np.abs(w - r).max())
        if port <= 50 * drift:
            rows.append((name, port, drift, float((p != w).mean())))
    return rows


def op_checks(n=1 << 16):
    """Share of elements where one op differs from its jitted flax / JAX
    bf16 result on the same bf16 input: SiLU and sigmoid (torch's
    ``F.silu`` and ``torch.sigmoid`` round once; JAX's StableHLO rounds the
    negate, exp, add, divide and, for SiLU, multiply each to bf16, as the
    port's ``ops/act.py`` does) and a biased conv (cuDNN / oneDNN round
    once; flax rounds the conv's output, then the bias add)."""
    import flax.linen as fnn
    import torch.nn.functional as F

    from litepi_tpu_torch.models.layers import conv_bias_apart
    from litepi_tpu_torch.ops.act import sigmoid, silu

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(0, 3, n).astype(np.float32)).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    shares = {}
    for name, jax_fn, once, port in (("silu", fnn.silu, F.silu, silu),
                                     ("sigmoid", jax.nn.sigmoid, torch.sigmoid, sigmoid)):
        want = np.asarray(jax.jit(jax_fn)(x).astype(jnp.float32))
        for how, fn in (("one rounding", once), ("each step rounded", port)):
            shares[f"{name}: {how}"] = float((fn(t).float().numpy() != want).mean())
    conv = fnn.Conv(32, (3, 3), padding=((1, 1), (1, 1)), use_bias=True, dtype=jnp.bfloat16)
    xi = rng.normal(0, 1, (2, 16, 16, 16)).astype(np.float32)
    v = conv.init(jax.random.key(0), xi)
    v = jax.tree.map(lambda a: a + 0.3, v)  # a non-zero bias
    want = np.asarray(conv.apply(v, xi).astype(jnp.float32)).transpose(0, 3, 1, 2)
    m = torch.nn.Conv2d(16, 32, 3, 1, 1).bfloat16()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(np.array(v["params"]["kernel"]).transpose(3, 2, 0, 1)))
        m.bias.copy_(torch.from_numpy(np.array(v["params"]["bias"])))
        xt = torch.from_numpy(xi).permute(0, 3, 1, 2).bfloat16()
        for k, y in (("biased conv: one rounding", m(xt)),
                     ("biased conv: bias apart", conv_bias_apart(m, xt))):
            shares[k] = float((y.float().numpy() != want).mean())
    return shares


def first_outside(rows):
    """The first row whose port difference exceeds JAX's drift, or None."""
    return next((r for r in rows if r[1] > r[2]), None)


def _bias_apart_forward(self, x):
    """``ConvBN.forward`` with a fused conv's bf16 bias added apart."""
    from litepi_tpu_torch.models.layers import conv_bias_apart

    x = conv_bias_apart(self.conv, x)
    if self.bn is not None:
        x = self.bn(x)
    return self.act(x)


TRIALS = (None, "silu and sigmoid rounded once", "bias apart everywhere")


def _round_once(act):
    """``act`` (``ops/act.py``'s ``silu`` or ``sigmoid``) rounding once in
    bf16, as torch's own op: the port before it rounded each step."""
    from litepi_tpu_torch.ops import act as ops_act

    once = {ops_act.silu: torch.nn.functional.silu, ops_act.sigmoid: torch.sigmoid}[act]
    return lambda x: once(x) if x.dtype == torch.bfloat16 else act(x)


def _default_pair_outputs():
    """{name: (port bf16, JAX bf16, JAX f32)} of the default pair as
    tests/test_torch_bf16_parity.py runs it: ``run_fused`` on the
    letterboxed and the canvas-sized scene, and ``classify``."""
    from tests import test_torch_bf16_parity as parity

    det, clf = parity.jax_init_vars(parity.SMALL, seed=0)
    jf = parity.JaxPipeline(parity.SMALL, det, clf)
    jb = parity.JaxPipeline(parity.SMALL, det, clf, dtype=jnp.bfloat16)
    port = parity.TwoStagePipeline.from_jax_vars(parity.port_config(parity.SMALL), det, clf,
                                                 dtype=torch.bfloat16, device="cpu")
    out = {}
    for scene, frames in (("letterboxed", peaked_frames()),
                          ("canvas", parity.canvas_frames("rgb"))):
        conf = parity.conf_in_gap(parity.jax_fused_scores(jb, frames),
                                  [parity.jax_fused_scores(jf, frames),
                                   parity.port_fused_scores(port, frames)])[0]
        out[scene] = tuple(parity.numpy_out(p.run_fused(frames, conf)) for p in (port, jb, jf))
    crops = np.random.default_rng(4).uniform(0, 1, (16, 64, 64, 3)).astype(np.float32)
    out["classify"] = ({"cls_probs": port.classify(crops).numpy()},
                       {"cls_probs": np.asarray(jb.classify(crops))},
                       {"cls_probs": np.asarray(jf.classify(crops))})
    return out


def pair_ratios(pair, trial=None):
    """{output: port difference / bound} of a zoo pair's bf16 ``run_fused``
    (tests/test_torch_bf16_zoo_parity.py's PAIRS and inputs), or of the
    default pair (``pair="default"``: ``{scene/output: ratio}``), with the
    port rounding as ``trial`` (one of TRIALS) says: a trial of that
    rounding, not the port's."""
    import litepi_tpu_torch.models.efficientnet as efficientnet
    import litepi_tpu_torch.models.layers as layers
    import litepi_tpu_torch.models.yolov5 as yolov5
    from tests.test_torch_bf16_parity import FLOOR, compare
    from tests.test_torch_bf16_zoo_parity import run_pair

    saved = (layers._ACTS["silu"], layers.ConvBN.forward, efficientnet.silu,
             efficientnet.sigmoid, yolov5.sigmoid)
    if trial == "silu and sigmoid rounded once":
        layers._ACTS["silu"] = efficientnet.silu = _round_once(efficientnet.silu)
        efficientnet.sigmoid = yolov5.sigmoid = _round_once(efficientnet.sigmoid)
    elif trial == "bias apart everywhere":
        layers.ConvBN.forward = _bias_apart_forward
    try:
        runs = _default_pair_outputs() if pair == "default" else {"": run_pair(pair)}
    finally:
        (layers._ACTS["silu"], layers.ConvBN.forward, efficientnet.silu,
         efficientnet.sigmoid, yolov5.sigmoid) = saved
    ratios = {}
    for name, (got, want, ref32) in runs.items():
        if name == "classify":
            d = float(np.abs(got["cls_probs"] - want["cls_probs"]).max())
            b = max(float(np.abs(ref32["cls_probs"] - want["cls_probs"]).max()),
                    FLOOR["cls_probs"])
            ratios["classify/cls_probs"] = d / b
            continue
        margins = compare(got, want, ref32, {k: float("inf") for k in
                                             ("boxes", "det_scores", "cls_probs", "cls_scores")})
        ratios.update({(f"{name}/" if name else "") + k: d / b for k, (d, b) in margins.items()})
    return ratios


# the modules fed one another's outputs in turn, for :func:`injected_rows`
CHAINS = {
    "mobilenetv2": ("stem", *[f"block{i}" for i in range(17)], "head_conv"),
    "yolov5n": ("stem", "down1", "c3_1", "down2", "c3_2", "down3", "c3_3", "down4", "c3_4",
                "sppf"),
}


def _five_step_silu(module) -> None:
    """Every ConvBN of ``module`` that runs torch's ``F.silu`` rounds at
    each step instead (the anchor-free YOLOv5n's one-rounding override
    undone)."""
    from litepi_tpu_torch.models.layers import ConvBN
    from litepi_tpu_torch.ops.act import silu

    for m in module.modules():
        if isinstance(m, ConvBN) and m.act is torch.nn.functional.silu:
            m.act = silu


def injected_rows(net, trial=None):
    """[(module, share of elements that differ, max difference)] of each
    module of ``CHAINS[net]`` fed JAX's own bf16 input (the JAX output of
    the module before it): where a module rounds as JAX's, only its conv
    summation order remains.  ``trial``: "bias apart everywhere" (see
    TRIALS) or "silu rounded at each step" (the anchor-free YOLOv5n)."""
    from litepi_tpu_torch.models import layers

    saved = layers.ConvBN.forward
    if trial == "bias apart everywhere":
        layers.ConvBN.forward = _bias_apart_forward
    try:
        (variables, fused), module, x = setup(net)
        if trial == "silu rounded at each step":
            _five_step_silu(module)
        j16 = jax_outputs(net, variables, fused, x, jnp.bfloat16)
        rows, chain = [], CHAINS[net]
        with torch.inference_mode():
            for i, name in enumerate(chain):
                src = x.transpose(0, 3, 1, 2) if i == 0 else j16[chain[i - 1]]
                got = getattr(module, name)(torch.from_numpy(src).to(torch.bfloat16))
                got = got.float().numpy()
                rows.append((name, float((got != j16[name]).mean()),
                             float(np.abs(got - j16[name]).max())))
    finally:
        layers.ConvBN.forward = saved
    return rows


def stem_injected_rows(net="yolov5n", names=("c3_1", "c3_3", "sppf", "cls0_out", "cls1_out",
                                                "cls2_out")):
    """{injected: [(module, share differing from JAX's bf16, port difference,
    JAX's drift)]} of the anchor-free YOLOv5n with SiLU rounded at each
    step, run whole, and with JAX's own stem output put in place of the
    port's (does the stem's conv order alone carry the difference?)."""
    (variables, fused), module, x = setup(net)
    _five_step_silu(module)
    j16 = jax_outputs(net, variables, fused, x, jnp.bfloat16)
    j32 = jax_outputs(net, variables, fused, x, jnp.float32)
    out = {}
    for inject in (False, True):
        hook = (module.stem.register_forward_hook(
            lambda m, i, o: torch.from_numpy(j16["stem"]).to(torch.bfloat16)) if inject else None)
        try:
            p16 = port_outputs(module, x)
        finally:
            if hook is not None:
                hook.remove()
        out[inject] = [(n, float((p16[n] != j16[n]).mean()), float(np.abs(p16[n] - j16[n]).max()),
                        float(np.abs(j16[n] - j32[n]).max())) for n in names]
    return out


def main(argv=None) -> int:
    argv = list(argv or [])
    jax.config.update("jax_platforms", "cpu")
    if argv[:1] == ["--inject"]:
        for net, trial in (("mobilenetv2", None), ("mobilenetv2", "bias apart everywhere"),
                           ("yolov5n", None), ("yolov5n", "silu rounded at each step")):
            print(f"== {net}{f' (trial: {trial})' if trial else ''}, each module fed JAX's input")
            for name, share, diff in injected_rows(net, trial):
                print(f"  {name:12s} differing {share:.4%}  max {diff:.3g}")
        for inject, rows in stem_injected_rows().items():
            print(f"== yolov5n, five-step SiLU, {'JAX' if inject else 'its own'} stem output")
            for name, share, diff, drift in rows:
                print(f"  {name:10s} differing {share:.4%}  port {diff:.3g}  drift {drift:.3g}")
        return 0
    if argv[:1] == ["--pairs"]:
        from tests.test_torch_bf16_zoo_parity import PAIRS

        for pair in ["default", *PAIRS]:
            for trial in TRIALS:
                ratios = {k: round(v, 3) for k, v in pair_ratios(pair, trial).items()}
                print(f"{pair}{f' (trial: {trial})' if trial else ''}: {ratios}", flush=True)
        return 0
    nets = argv or list(NETS)
    for net in nets:
        rows = layer_table(net)
        print(f"== {net}: {len(rows)} module outputs compared")
        for name, port, drift, share in rows[:12]:
            print(f"  {name:40s} port {port:.3g}  drift {drift:.3g}  ratio "
                  f"{port / max(drift, 1e-30):.3g}  differing {share:.2%}")
        first = first_outside(rows)
        print(f"  first outside the drift: {first}")
        worst = max(rows, key=lambda r: r[1] / max(r[2], 1e-30))
        print(f"  largest ratio: {worst}")
        print(f"  last: {rows[-1]}")
    for k, share in op_checks().items():
        print(f"op {k}: differs from flax's bf16 in {share:.2%} of elements")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
