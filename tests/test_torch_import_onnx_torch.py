"""The port's ONNX and torch importers (litepi_tpu_torch/weights/
{onnx,torch}_import.py) against the JAX package's.

ONNX: a fused detector export (the JAX emitter's, from seeded variables)
and an unfused one (the Ultralytics-keyed torch mirror's state dict as
initializers); a name-preserving classifier export (a torchvision state
dict, some names behind Identity nodes as ``torch.onnx.export``
deduplicates them), a fused one (the JAX emitter's) and a traced one (the
real ``torch.onnx.export`` of the ShuffleNetV2 mirror, BatchNorm folded and
initializers renamed).  torch: an Ultralytics training container read
through the stub unpickler, the four torchvision classifiers' ``.pth``,
and Ultralytics-keyed YOLOv5u and YOLOv11 state dicts (YOLOv11's attention
qkv conv re-ordered from torch's heads-major packing).  For each, the
port's variables equal the JAX importer's leaf for leaf; malformed inputs
raise the same error class; the stub unpickler refuses arbitrary
callables.  One pair per format (ONNX; ``.pt`` + ``.pth``) goes on through
both pipelines, float32 on the CPU, within tests/test_torch_pipeline.py's
tolerances.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

from litepi_tpu.core import types as JT
from litepi_tpu.models import YoloLitePi
from litepi_tpu.models import build_classifier as jax_build_classifier
from litepi_tpu.models.yolov5 import YoloV5
from litepi_tpu.models.yolov11 import YoloV11
from litepi_tpu.weights import ncnn_export, onnx_export
from litepi_tpu.weights import onnx_import as jax_onnx
from litepi_tpu.weights import torch_import as jax_torch
from litepi_tpu_torch.weights import onnx_import as port_onnx
from litepi_tpu_torch.weights import torch_import as port_torch
from tests.torch_artifacts import save_ultralytics_container
from tests.torch_port_helpers import (
    assert_tree_equal,
    one_torch_thread,  # noqa: F401 (a fixture, used by pytestmark)
    random_jax_vars,
)
from tests.torch_refs import (
    EfficientNetB0T,
    MobileNetV2T,
    ResNet18T,
    ShuffleNetV2T,
    export_real_onnx,
    randomize_bn_stats,
)
from tests.torch_yolo_ref import YoloV8T

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = JT.YOLO_PLUS_V2
TORCHVISION = {"shufflenetv2": ShuffleNetV2T, "resnet18": ResNet18T,
               "mobilenetv2": MobileNetV2T, "efficientnet": EfficientNetB0T}


def _mirror(seed=0):
    """The Ultralytics-keyed YOLOv8 mirror at yolo_plus_v2's widths, with
    BatchNorm statistics randomised."""
    torch.manual_seed(seed)
    tm = YoloV8T(CFG.channels, CFG.depths, nc=1, reg_max=CFG.reg_max,
                 neck_shortcut=CFG.neck_shortcut, neck_down=CFG.neck_down_channels)
    randomize_bn_stats(tm, seed=seed + 1)
    return tm.eval()


def _tv(arch, num_classes=10, seed=0):
    torch.manual_seed(seed)
    m = TORCHVISION[arch](num_classes)
    randomize_bn_stats(m, seed=seed + 1)
    return m.eval()


def _sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _both(fn_name, module_pair, *args):
    """``fn_name(*args)`` through the JAX module and the port's module."""
    return tuple(getattr(m, fn_name)(*args) for m in module_pair)


ONNX = (jax_onnx, port_onnx)
TORCH = (jax_torch, port_torch)


@pytest.fixture(scope="module")
def det_vars():
    return random_jax_vars(YoloLitePi(CFG), seed=3)


@pytest.fixture(scope="module")
def cls_vars():
    return random_jax_vars(jax_build_classifier("shufflenetv2", 91), seed=4)


# ---- ONNX ---------------------------------------------------------------


def test_onnx_fused_detector_equals_jax(det_vars, tmp_path):
    path = str(tmp_path / "det.onnx")
    onnx_export.export_detector_onnx(det_vars, CFG, path)
    want, got = _both("convert_detector_onnx", ONNX, path, CFG.depths)
    assert_tree_equal(got, want)
    assert_tree_equal(port_onnx.read_onnx_initializers(path),
                      jax_onnx.read_onnx_initializers(path))


def test_onnx_unfused_detector_equals_jax(tmp_path):
    sd = _sd(_mirror())
    path = tmp_path / "det.onnx"
    path.write_bytes(onnx_export.onnx_model_bytes([], sd, (1, 3, 64, 64), (1, 5, 84)))
    want, got = _both("convert_detector_onnx", ONNX, str(path), CFG.depths)
    assert_tree_equal(got, want)
    # an unfused dict passes the defusion untouched
    assert_tree_equal(port_onnx.defuse_state_dict(sd), sd)


@pytest.mark.parametrize("arch", ["shufflenetv2", "resnet18"])
def test_onnx_name_preserving_classifier_equals_jax(arch, tmp_path):
    sd = _sd(_tv(arch))
    # torch.onnx.export keeps one of two bit-equal initializers and
    # re-materialises the other name through an Identity node
    names = sorted(k for k in sd if k.endswith(".running_mean"))[:3]
    nodes = [("Identity", f"alias{i}", [names[0]], [n], {}) for i, n in enumerate(names[1:])]
    inits = {k: v for k, v in sd.items() if k not in names[1:]}
    for n in names[1:]:
        sd[n] = sd[names[0]]
    path = tmp_path / "cls.onnx"
    path.write_bytes(onnx_export.onnx_model_bytes(nodes, inits, (1, 3, 64, 64), (1, 10)))
    assert_tree_equal(port_onnx.read_onnx_state_dict(str(path)),
                      jax_onnx.read_onnx_state_dict(str(path)))
    want, got = _both("convert_classifier_onnx", ONNX, arch, str(path))
    assert_tree_equal(got, want)


def test_onnx_fused_classifier_equals_jax(cls_vars, tmp_path):
    path = str(tmp_path / "cls.onnx")
    onnx_export.export_classifier_onnx("shufflenetv2", cls_vars, 91, path)
    want, got = _both("convert_classifier_onnx_fused", ONNX, path)
    assert got[1] == want[1] == 91
    assert_tree_equal(got[0], want[0])


def test_onnx_traced_classifier_equals_jax(tmp_path):
    path = str(tmp_path / "traced.onnx")
    export_real_onnx(_tv("shufflenetv2"), torch.zeros(1, 3, 64, 64), path, fused=True)
    want, got = _both("convert_classifier_onnx_traced", ONNX, path)
    assert got[1] == want[1] == 10
    assert_tree_equal(got[0], want[0])


def _unfused_classifier_onnx(tmp):
    path = tmp / "unfused.onnx"
    path.write_bytes(onnx_export.onnx_model_bytes([], _sd(_tv("shufflenetv2")),
                                                  (1, 3, 64, 64), (1, 10)))
    return str(path)


def _folded_classifier_onnx(tmp):
    path = str(tmp / "folded.onnx")
    export_real_onnx(_tv("shufflenetv2"), torch.zeros(1, 3, 64, 64), path, fused=True)
    return path


# each case takes (onnx module, torch module, tmp)
MALFORMED = {
    "onnx_unfused_as_fused_classifier": lambda o, t, tmp: o.convert_classifier_onnx_fused(
        _unfused_classifier_onnx(tmp)),
    "onnx_folded_as_name_preserving": lambda o, t, tmp: o.convert_classifier_onnx(
        "shufflenetv2", _folded_classifier_onnx(tmp)),
    "onnx_unfused_as_traced": lambda o, t, tmp: o.convert_classifier_onnx_traced(
        _unfused_classifier_onnx(tmp)),
    "onnx_classifier_as_detector": lambda o, t, tmp: o.convert_detector_onnx(
        _unfused_classifier_onnx(tmp)),
    "onnx_bad_wire_type": lambda o, t, tmp: o.read_onnx_initializers(bytes([0x3B, 0, 0])),
    "torch_unknown_arch": lambda o, t, tmp: t.convert_classifier_state_dict(
        "vgg16", _sd(_tv("resnet18"))),
    "torch_wrong_arch": lambda o, t, tmp: t.convert_classifier_state_dict(
        "mobilenetv2", _sd(_tv("resnet18"))),
    "torch_missing_file": lambda o, t, tmp: t.load_torch_state_dict(str(tmp / "absent.pt")),
    "torch_no_tensors": lambda o, t, tmp: t.load_ultralytics_container(_no_tensors(tmp)),
}


def _no_tensors(tmp):
    path = str(tmp / "empty.pt")
    torch.save({"model": [1, 2], "epoch": 3}, path)
    return path


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_inputs_raise_the_same_error(tmp_path, case):
    errors = []
    for side in ((jax_onnx, jax_torch), (port_onnx, port_torch)):
        with pytest.raises(Exception) as e:
            MALFORMED[case](*side, tmp_path)
        errors.append(e.value)
    assert type(errors[1]) is type(errors[0]), errors
    assert str(errors[1]) == str(errors[0])


# ---- torch ----------------------------------------------------------------


def test_ultralytics_container_equals_jax(tmp_path):
    """A ``best.pt`` container (fp16, the class from a package that is not
    installed) through the stub unpickler, on both sides."""
    path = str(tmp_path / "best.pt")
    save_ultralytics_container(_mirror(), path)
    want, got = _both("load_torch_state_dict", TORCH, path)
    assert_tree_equal(got, want)
    assert all(v.dtype == np.float32 for v in got.values())
    assert_tree_equal(port_torch.load_ultralytics_container(path), got)
    want = jax_torch.convert_detector_state_dict(jax_onnx.defuse_state_dict(want), CFG.depths)
    got = port_torch.convert_detector_state_dict(port_onnx.defuse_state_dict(got), CFG.depths)
    assert_tree_equal(got, want)


@pytest.mark.parametrize("arch", sorted(TORCHVISION))
def test_torchvision_classifiers_equal_jax(arch, tmp_path):
    path = str(tmp_path / f"{arch}.pth")
    torch.save(_tv(arch, 91).state_dict(), path)
    want, got = _both("load_torch_state_dict", TORCH, path)
    assert_tree_equal(got, want)
    want, got = _both("convert_classifier_state_dict", TORCH, arch, got)
    assert_tree_equal(got, want)


def _unfused_from_fused(fused, seed):
    """An Ultralytics-keyed training-form state dict with the keys of
    ``fused``: every ``X.conv`` bias becomes a BatchNorm ``X.bn`` with
    random statistics."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in fused.items():
        if k.endswith(".conv.bias"):
            base, n = k[: -len(".conv.bias")], v.shape[0]
            out[f"{base}.bn.weight"] = rng.uniform(0.8, 1.2, n).astype(np.float32)
            out[f"{base}.bn.bias"] = v
            out[f"{base}.bn.running_mean"] = rng.normal(0, 0.1, n).astype(np.float32)
            out[f"{base}.bn.running_var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("variant", ["yolov5u", "yolov11"])
@pytest.mark.parametrize("form", ["fused", "unfused"])
def test_zoo_detector_state_dicts_equal_jax(variant, form, tmp_path):
    """Ultralytics-keyed YOLOv5u / YOLOv11 ``.pt`` state dicts; YOLOv11's
    qkv conv and its BatchNorm come in torch's heads-major order."""
    if variant == "yolov5u":
        model, to_sd = YoloV5(num_classes=1, anchor_free=True), ncnn_export.yolov5u_fused_state_dict
    else:
        model, to_sd = YoloV11(num_classes=1), ncnn_export.yolov11_fused_state_dict
    sd = to_sd(random_jax_vars(model, seed=5))
    if form == "unfused":
        sd = _unfused_from_fused(sd, seed=6)
    path = str(tmp_path / f"{variant}.pt")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    want, got = _both("load_torch_state_dict", TORCH, path)
    assert_tree_equal(got, want)
    fn = f"convert_{variant}_state_dict"
    want = getattr(jax_torch, fn)(jax_onnx.defuse_state_dict(want))
    got = getattr(port_torch, fn)(port_onnx.defuse_state_dict(got))
    assert_tree_equal(got, want)
    if variant == "yolov11" and form == "unfused":
        # the qkv BatchNorm's statistics are torch's, out of torch's order
        qkv = got["batch_stats"]["c2psa"]["m0"]["attn"]["qkv"]["bn"]["mean"]
        src = sd["model.10.m.0.attn.qkv.bn.running_mean"]
        assert not np.array_equal(qkv, src) and np.array_equal(np.sort(qkv), np.sort(src))


def test_stub_unpickler_refuses_arbitrary_callables(tmp_path):
    """A crafted 'weights' pickle must not execute importable callables —
    the obvious ones (os.system) nor exec gadgets inside otherwise-trusted
    packages (numpy.testing._private.utils.runstring): the port's stub
    unpickler resolves only an allowlist of exact symbols."""
    marker = tmp_path / "pwned"

    class Evil:
        def __reduce__(self):
            import os

            return (os.system, (f"touch {marker}",))

    class EvilNumpyGadget:
        def __reduce__(self):
            from numpy.testing._private.utils import runstring

            return (runstring, (f"import os; os.system('touch {marker}')", {}))

    for payload in (Evil(), EvilNumpyGadget()):
        path = tmp_path / "evil.pt"
        with open(path, "wb") as f:
            pickle.dump({"model": payload}, f)
        for load in (port_torch.load_ultralytics_container, port_torch.load_torch_state_dict):
            try:
                load(str(path))
            except Exception:
                pass  # refusing loudly is fine; executing is not
            assert not marker.exists(), "a pickled payload was executed"


# ---- both pipelines, one pair per format ----------------------------------


def _pipelines_agree(det, clf):
    """``run_fused`` of the JAX and the port pipelines on the same
    variables (float32, CPU, 160 input at full width, BGR frames) at a
    threshold in a gap of the candidate scores: boxes within 1e-3 px,
    scores 1e-6, probabilities 1e-5, discrete outputs equal."""
    from litepi_tpu.pipeline import TwoStagePipeline as JaxPipeline
    from litepi_tpu_torch.pipeline import TwoStagePipeline
    from tests.test_torch_bf16_parity import conf_in_gap, jax_fused_scores, numpy_out
    from tests.torch_port_helpers import peaked_frames, port_config

    cfg = JT.PipelineConfig(
        detector=dataclasses.replace(CFG, input_size=160),
        nms=JT.NMSConfig(max_candidates=64, max_detections=8, min_area=4.0),
        det_input_size=160, input_color="bgr")
    jp = JaxPipeline(cfg, det, clf)
    port = TwoStagePipeline.from_jax_vars(port_config(cfg), det, clf, device="cpu")
    frames = peaked_frames()
    scores = jax_fused_scores(jp, frames)
    conf, half_gap, _ = conf_in_gap(scores, [scores], 1, 6)
    assert half_gap > 1e-5
    got, want = numpy_out(port.run_fused(frames, conf)), numpy_out(jp.run_fused(frames, conf))
    v = want["valid"]
    assert v.any() and np.array_equal(got["valid"], v)
    for k, tol in (("boxes", 1e-3), ("det_scores", 1e-6), ("cls_probs", 1e-5)):
        np.testing.assert_allclose(got[k][v], want[k][v], atol=tol, rtol=0, err_msg=k)
    for k in ("det_class_ids", "cls_labels"):
        np.testing.assert_array_equal(got[k][v], want[k][v], err_msg=k)


def test_onnx_pair_through_both_pipelines(det_vars, cls_vars, tmp_path):
    det_path, cls_path = str(tmp_path / "det.onnx"), str(tmp_path / "cls.onnx")
    onnx_export.export_detector_onnx(det_vars, CFG, det_path)
    onnx_export.export_classifier_onnx("shufflenetv2", cls_vars, 91, cls_path)
    _pipelines_agree(port_onnx.convert_detector_onnx(det_path, CFG.depths),
                     port_onnx.convert_classifier_onnx_fused(cls_path)[0])


def test_pt_pth_pair_through_both_pipelines(tmp_path):
    det_path, cls_path = str(tmp_path / "best.pt"), str(tmp_path / "cls.pth")
    save_ultralytics_container(_mirror(seed=7), det_path)
    torch.save(_tv("shufflenetv2", 91, seed=8).state_dict(), cls_path)
    det = port_torch.convert_detector_state_dict(
        port_onnx.defuse_state_dict(port_torch.load_torch_state_dict(det_path)), CFG.depths)
    clf = port_torch.convert_classifier_state_dict(
        "shufflenetv2", port_torch.load_torch_state_dict(cls_path))
    _pipelines_agree(det, clf)
