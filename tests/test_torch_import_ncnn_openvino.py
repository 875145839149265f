"""The port's NCNN and OpenVINO importers (litepi_tpu_torch/weights/
{ncnn,openvino}_import.py) against the JAX package's.

The JAX emitters write full-width graphs from seeded JAX variables: NCNN
pairs and OpenVINO IRs of yolo_plus_v2, yolo_plus_v1, yolov8n, yolov5nu
and yolov11n and of the ShuffleNetV2 classifier, plus an fp16-compressed IR
(the ``ovc`` default) made from an emitted one.  For each, the port's
topology probe names the same variant as the JAX one, and the port's
variables equal the JAX importer's leaf for leaf (``np.array_equal``, the
same tree).  Malformed inputs raise the same error class on both sides.
One pair (NCNN) goes on through both pipelines, float32 on the CPU, within
tests/test_torch_pipeline.py's tolerances; the OpenVINO trees equal the
NCNN ones, so that run covers both formats.
"""

import dataclasses

import numpy as np
import pytest

from litepi_tpu.core import types as JT
from litepi_tpu.models import YoloLitePi
from litepi_tpu.models import build_classifier as jax_build_classifier
from litepi_tpu.models.yolov5 import YoloV5
from litepi_tpu.models.yolov11 import YoloV11
from litepi_tpu.weights import ncnn_export, openvino_export
from litepi_tpu.weights import ncnn_import as jax_ncnn
from litepi_tpu.weights import openvino_import as jax_ov
from litepi_tpu_torch.weights import ncnn_import as port_ncnn
from litepi_tpu_torch.weights import openvino_import as port_ov
from tests.test_ncnn_import import _compress_ir_to_fp16
from tests.torch_port_helpers import (
    assert_tree_equal,
    one_torch_thread,  # noqa: F401 (a fixture, used by pytestmark)
    random_jax_vars,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PLUS = {"yolo_plus_v2": JT.YOLO_PLUS_V2, "yolo_plus_v1": JT.YOLO_PLUS_V1,
        "yolov8n": JT.YOLOV8N}
ZOO = {"yolov5nu": lambda: YoloV5(num_classes=1, anchor_free=True),
       "yolov11n": lambda: YoloV11(num_classes=1)}
VARIANTS = [*PLUS, *ZOO]
CLS_CLASSES = 91


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """{name: {"vars", "param", "bin", "xml", "xbin"}} for every detector
    variant and "classifier", emitted by the JAX emitters."""
    root = tmp_path_factory.mktemp("emitted")
    out = {}
    for i, name in enumerate(VARIANTS):
        model = YoloLitePi(PLUS[name]) if name in PLUS else ZOO[name]()
        v = random_jax_vars(model, seed=i)
        p = {k: str(root / f"{name}.{ext}") for k, ext in
             (("param", "param"), ("bin", "bin"), ("xml", "xml"), ("xbin", "ov.bin"))}
        if name in PLUS:
            ncnn_export.export_detector_ncnn(v, PLUS[name], p["param"], p["bin"])
            openvino_export.export_detector_openvino(v, PLUS[name], p["xml"], p["xbin"])
        else:
            ncnn_export.export_detector_ncnn_variant(v, name, p["param"], p["bin"])
            openvino_export.export_detector_openvino_variant(v, name, p["xml"], p["xbin"])
        out[name] = dict(vars=v, **p)
    v = random_jax_vars(jax_build_classifier("shufflenetv2", CLS_CLASSES), seed=9)
    # the classifier's .bin files sit beside their graphs, as the CLI reads them
    p = {k: str(root / name) for k, name in (("param", "cls_ncnn.param"), ("bin", "cls_ncnn.bin"),
                                             ("xml", "cls.xml"), ("xbin", "cls.bin"))}
    ncnn_export.export_classifier_ncnn("shufflenetv2", v, CLS_CLASSES, p["param"], p["bin"])
    openvino_export.export_classifier_openvino("shufflenetv2", v, CLS_CLASSES, p["xml"])
    out["classifier"] = dict(vars=v, **p)
    fx, fb = str(root / "fp16.xml"), str(root / "fp16.bin")
    _compress_ir_to_fp16(out["yolo_plus_v1"]["xml"], out["yolo_plus_v1"]["xbin"], fx, fb)
    out["fp16"] = dict(xml=fx, xbin=fb)
    return out


def _probe_ncnn(mod, layers):
    """The e2e CLI's variant probe of a parsed graph, through ``mod``."""
    try:
        return mod.infer_detector_config(layers, 640).name
    except ValueError:
        pass
    for name in ZOO:
        try:
            mod.verify_ncnn_variant_topology(layers, name)
            return name
        except ValueError:
            continue
    return None


def _probe_ov(mod, types, xml):
    graph = mod.parse_openvino_xml(xml)
    for cfg in (types.YOLO_PLUS_V2, types.YOLO_PLUS_V1, types.YOLOV8N):
        try:
            mod.verify_openvino_topology(xml, cfg, graph=graph)
            return cfg.name
        except ValueError:
            continue
    for name in ZOO:
        try:
            mod.verify_openvino_variant_topology(xml, name, graph=graph)
            return name
        except ValueError:
            continue
    return None


@pytest.mark.parametrize("name", VARIANTS)
def test_ncnn_detector_equals_jax(art, name):
    a = art[name]
    jl, pl = jax_ncnn.parse_ncnn_param(a["param"]), port_ncnn.parse_ncnn_param(a["param"])
    assert _probe_ncnn(port_ncnn, pl) == _probe_ncnn(jax_ncnn, jl) == name
    if name in PLUS:
        want, jcfg = jax_ncnn.convert_detector_ncnn(a["param"], a["bin"])
        got, pcfg = port_ncnn.convert_detector_ncnn(a["param"], a["bin"])
        assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    else:
        want = jax_ncnn.convert_detector_ncnn_variant(a["param"], a["bin"], name)
        got = port_ncnn.convert_detector_ncnn_variant(a["param"], a["bin"], name)
    assert_tree_equal(got, want)
    assert "batch_stats" in got  # defused: identity BatchNorms around the biases


@pytest.mark.parametrize("name", VARIANTS)
def test_openvino_detector_equals_jax(art, name):
    from litepi_tpu_torch.core import types as PT

    a = art[name]
    assert _probe_ov(port_ov, PT, a["xml"]) == _probe_ov(jax_ov, JT, a["xml"]) == name
    if name in PLUS:
        want, _ = jax_ov.convert_detector_openvino(a["xml"], a["xbin"])
        got, pcfg = port_ov.convert_detector_openvino(a["xml"], a["xbin"])
        assert pcfg.name == name
    else:
        want = jax_ov.convert_detector_openvino_variant(a["xml"], a["xbin"], name)
        got = port_ov.convert_detector_openvino_variant(a["xml"], a["xbin"], name)
    assert_tree_equal(got, want)
    # the same fused weights in both formats give the same variables
    assert_tree_equal(got, port_ncnn.convert_detector_ncnn_variant(a["param"], a["bin"], name)
                      if name in ZOO else port_ncnn.convert_detector_ncnn(a["param"], a["bin"])[0])


def test_fp16_compressed_ir_equals_jax(art):
    a = art["fp16"]
    sd = port_ov.openvino_state_dict(a["xml"], a["xbin"])
    assert_tree_equal(sd, jax_ov.openvino_state_dict(a["xml"], a["xbin"]))
    assert any(k.endswith(".bias") for k in sd)
    want, jcfg = jax_ov.convert_detector_openvino(a["xml"], a["xbin"])
    got, pcfg = port_ov.convert_detector_openvino(a["xml"], a["xbin"])
    assert pcfg.name == jcfg.name == "yolo_plus_v1"
    assert_tree_equal(got, want)
    # fp16 constants widen exactly: the f32 IR's weights rounded through fp16
    f32 = port_ov.openvino_state_dict(art["yolo_plus_v1"]["xml"], art["yolo_plus_v1"]["xbin"])
    for k, v in f32.items():
        assert np.array_equal(sd[k], v.astype(np.float16).astype(np.float32)), k


@pytest.mark.parametrize("fmt", ["ncnn", "openvino"])
def test_classifier_equals_jax(art, fmt):
    a = art["classifier"]
    if fmt == "ncnn":
        want = jax_ncnn.convert_classifier_ncnn(a["param"], a["bin"])
        got = port_ncnn.convert_classifier_ncnn(a["param"], a["bin"])
    else:
        want = jax_ov.convert_classifier_openvino_fused(a["xml"], a["xbin"])
        got = port_ov.convert_classifier_openvino_fused(a["xml"], a["xbin"])
    assert got[1] == want[1] == CLS_CLASSES
    assert_tree_equal(got[0], want[0])
    assert "batch_stats" not in got[0]  # deploy form


def _half_xml(art, tmp):
    path = tmp / "half.xml"
    text = open(art["yolo_plus_v2"]["xml"]).read()
    path.write_text(text[: len(text) // 2])
    return str(path)


def _truncated_bin(art):
    return open(art["yolo_plus_v2"]["bin"], "rb").read()[:-64]


# each case takes (ncnn module, openvino module, types module, art, tmp)
MALFORMED = {
    # an NCNN .param with another export's .bin
    "ncnn_mispaired_bin": lambda n, o, T, art, tmp: n.read_ncnn_bin(
        n.parse_ncnn_param(art["yolo_plus_v1"]["param"]), art["yolo_plus_v2"]["bin"]),
    "ncnn_truncated_bin": lambda n, o, T, art, tmp: n.read_ncnn_bin(
        n.parse_ncnn_param(art["yolo_plus_v2"]["param"]), _truncated_bin(art)),
    "ncnn_bad_magic": lambda n, o, T, art, tmp: n.parse_ncnn_param(
        "7767518\n1 1\nInput in0 0 1 in0\n"),
    # the v2 graph held against the v1 config
    "ncnn_wrong_topology": lambda n, o, T, art, tmp: n.verify_ncnn_topology(
        n.parse_ncnn_param(art["yolo_plus_v2"]["param"]), T.YOLO_PLUS_V1),
    "ncnn_wrong_variant": lambda n, o, T, art, tmp: n.verify_ncnn_variant_topology(
        n.parse_ncnn_param(art["yolov5nu"]["param"]), "yolov11n"),
    # a 1-class graph read as 3 classes
    "ncnn_class_mismatch": lambda n, o, T, art, tmp: n.verify_ncnn_variant_topology(
        n.parse_ncnn_param(art["yolov11n"]["param"]), "yolov11n", num_classes=3),
    "ncnn_unknown_variant": lambda n, o, T, art, tmp: n.verify_ncnn_variant_topology(
        n.parse_ncnn_param(art["yolov11n"]["param"]), "yolov9"),
    "ncnn_no_detector_match": lambda n, o, T, art, tmp: n.infer_detector_config(
        n.parse_ncnn_param(art["yolov11n"]["param"])),
    "ncnn_classifier_from_detector": lambda n, o, T, art, tmp: n.convert_classifier_ncnn(
        art["yolo_plus_v2"]["param"], art["yolo_plus_v2"]["bin"]),
    "openvino_wrong_topology": lambda n, o, T, art, tmp: o.verify_openvino_topology(
        art["yolo_plus_v2"]["xml"], T.YOLO_PLUS_V1),
    "openvino_class_mismatch": lambda n, o, T, art, tmp: o.verify_openvino_variant_topology(
        art["yolov5nu"]["xml"], "yolov5nu", num_classes=3),
    "openvino_no_detector_match": lambda n, o, T, art, tmp: o.convert_detector_openvino(
        art["classifier"]["xml"], art["classifier"]["xbin"]),
    "openvino_classifier_from_detector": lambda n, o, T, art, tmp: (
        o.convert_classifier_openvino_fused(art["yolo_plus_v2"]["xml"],
                                            art["yolo_plus_v2"]["xbin"])),
    "openvino_malformed_xml": lambda n, o, T, art, tmp: o.parse_openvino_xml(
        _half_xml(art, tmp)),
    "openvino_missing_bin": lambda n, o, T, art, tmp: o.openvino_state_dict(
        art["yolo_plus_v2"]["xml"], str(tmp / "absent.bin")),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_inputs_raise_the_same_error(art, tmp_path, case):
    """The same error class and message on both sides."""
    from litepi_tpu_torch.core import types as PT

    errors = []
    for side in ((jax_ncnn, jax_ov, JT), (port_ncnn, port_ov, PT)):
        with pytest.raises(Exception) as e:
            MALFORMED[case](*side, art, tmp_path)
        errors.append(e.value)
    assert type(errors[1]) is type(errors[0]), errors
    assert str(errors[1]) == str(errors[0])


def test_ncnn_pair_through_both_pipelines(art):
    """The imported yolo_plus_v2 + ShuffleNetV2 pair through the JAX and
    the port pipelines (float32, CPU, 160 input at full width, BGR frames):
    ``run_fused`` at a threshold in a gap of the candidate scores, boxes
    within 1e-3 px, scores 1e-6, probabilities 1e-5, discrete outputs
    equal."""
    from litepi_tpu.pipeline import TwoStagePipeline as JaxPipeline
    from litepi_tpu_torch.pipeline import TwoStagePipeline
    from tests.test_torch_bf16_parity import conf_in_gap, jax_fused_scores, numpy_out
    from tests.torch_port_helpers import peaked_frames, port_config

    det, _ = port_ncnn.convert_detector_ncnn(art["yolo_plus_v2"]["param"],
                                             art["yolo_plus_v2"]["bin"])
    clf, _ = port_ncnn.convert_classifier_ncnn(art["classifier"]["param"],
                                               art["classifier"]["bin"])
    cfg = JT.PipelineConfig(
        detector=dataclasses.replace(JT.YOLO_PLUS_V2, input_size=160),
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
