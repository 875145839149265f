"""The port's ONNX and OpenVINO emitters and their torch interpreters
against the JAX package's, on the same seeded Flax-named trees.

* ``litepi_tpu_torch/weights/onnx_export.py`` writes ``.onnx`` files
  byte-equal to the JAX emitter's for the yolo_plus family (yolo_plus_v2,
  yolo_plus_v1, yolov8n) and the ShuffleNetV2-91 classifier;
  ``openvino_export.py`` writes ``.xml`` / ``.bin`` pairs byte-equal to the
  JAX emitter's for those and yolov5nu and yolov11n;
* ``run_onnx_graph`` and ``run_ir_graph`` in torch (``device="cpu"``)
  match the JAX interpreters on emitted graphs at 64 px within 1e-5
  relative to the output's largest magnitude (a detector in each format;
  the classifier's ops against JAX in tests/test_torch_export_ncnn.py), and
  the port's own model plus decode on every family each format covers
  (yolov11n's IR: its attention MatMul and GroupConvolution).
"""

import numpy as np
import pytest
import torch

from litepi_tpu.weights import onnx_import as jax_onnx
from litepi_tpu.weights import openvino_import as jax_ov
from litepi_tpu_torch.weights import onnx_import as port_onnx
from litepi_tpu_torch.weights import openvino_import as port_ov
from tests import torch_graph_helpers as G
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 64
TOL = 1e-5
CASES = [(fmt, f) for fmt in ("onnx", "openvino") for f in G.FORMAT_FAMILIES[fmt]]


@pytest.fixture(scope="module")
def trees():
    fams = sorted({f for _, f in CASES})
    return {f: G.family_vars(f, seed=10 + i) for i, f in enumerate(fams)}


@pytest.mark.parametrize("fmt, family", CASES)
def test_files_byte_equal_to_jax(trees, tmp_path, fmt, family):
    want = G.emit(G.jax_package(), fmt, family, trees[family], str(tmp_path / "jax"))
    got = G.emit(G.port_package(), fmt, family, trees[family], str(tmp_path / "port"))
    assert sorted(got) == sorted(want)
    for ext in want:
        with open(got[ext], "rb") as g, open(want[ext], "rb") as w:
            assert g.read() == w.read(), ext


@pytest.fixture(scope="module")
def emitted(trees, tmp_path_factory):
    """{(fmt, family): (paths, image (3, SIZE, SIZE))} of the port's
    emission at SIZE."""
    root = str(tmp_path_factory.mktemp("graphs"))
    out = {}
    for i, (fmt, f) in enumerate(CASES):
        img = np.random.default_rng(i).uniform(0, 1, (3, SIZE, SIZE)).astype(np.float32)
        out[fmt, f] = G.emit(G.port_package(), fmt, f, trees[f], root, "fp32", SIZE), img
    return out


def _run(mod, fmt, paths, img, **kw):
    """The graph's output through ``mod``'s interpreter, batch dim dropped."""
    if fmt == "onnx":
        nodes, inits, inputs, outputs = port_onnx.read_onnx_graph(paths["onnx"])
        blobs = mod.run_onnx_graph(nodes, inits, {inputs[0]: img[None]}, **kw)
        return np.asarray(blobs[outputs[0]])[0]
    return np.asarray(mod.run_ir_graph(paths["xml"], paths["bin"], img[None], **kw))[0]


@pytest.mark.parametrize("fmt, family", [("onnx", "yolo_plus_v1"), ("openvino", "yolov5nu")])
def test_interpreter_matches_jax_interpreter(emitted, fmt, family):
    paths, img = emitted[fmt, family]
    jax_mod, port_mod = (jax_onnx, port_onnx) if fmt == "onnx" else (jax_ov, port_ov)
    want = _run(jax_mod, fmt, paths, img)
    got = _run(port_mod, fmt, paths, img, device="cpu")
    assert got.shape == want.shape
    assert G.rel_err(got, want) <= TOL


@pytest.mark.parametrize("fmt, family", CASES)
def test_interpreter_matches_the_port_model(trees, emitted, fmt, family):
    paths, img = emitted[fmt, family]
    got = _run(port_onnx if fmt == "onnx" else port_ov, fmt, paths, img, device="cpu")
    want = G.port_graph_output(G.port_model(family, trees[family]), img,
                               detector=family != G.CLASSIFIER)
    assert got.shape == want.shape
    assert G.rel_err(got, want) <= TOL


def test_run_ir_graph_values_and_device(emitted):
    paths, img = emitted["openvino", "yolov8n"]
    out, values = port_ov.run_ir_graph(paths["xml"], paths["bin"], img[None],
                                       return_values=True, device="cpu")
    assert isinstance(out, np.ndarray) and all(
        isinstance(v, np.ndarray) for v in values.values())
    graph = port_ov.parse_openvino_xml(paths["xml"])
    assert port_ov._topo_order(graph) == jax_ov._topo_order(jax_ov.parse_openvino_xml(paths["xml"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_ov.run_ir_graph(paths["xml"], paths["bin"], img[None])
        nodes, inits, inputs, _ = port_onnx.read_onnx_graph(emitted["onnx", "yolov8n"][0]["onnx"])
        with pytest.raises(RuntimeError, match="CUDA"):
            port_onnx.run_onnx_graph(nodes, inits, {inputs[0]: img[None]})
