"""The port's NCNN emitter and its torch NCNN interpreter against the JAX
package's, on the same seeded Flax-named trees.

* ``litepi_tpu_torch/weights/ncnn_export.py`` writes ``.param`` / ``.bin``
  pairs byte-equal to the JAX emitter's, fp32 and fp16, for every family it
  covers (yolo_plus_v2, yolo_plus_v1, yolov8n, yolov5nu, yolov11n and the
  ShuffleNetV2-91 classifier);
* the tree-form BatchNorm folds in ``weights/fold_bn.py`` equal the JAX
  folds bit for bit, and refuse what the JAX fold refuses;
* ``run_ncnn_graph`` in torch (``device="cpu"``) matches the JAX
  interpreter on the emitted graphs at 64 px within 1e-5 relative to the
  output's largest magnitude (yolov11n with its C2f-family body, C2PSA
  attention and depthwise head; the classifier), and the port's own model
  plus decode on every family.
"""

import numpy as np
import pytest
import torch

from litepi_tpu.weights import fold_bn as jax_fold
from litepi_tpu.weights import ncnn_import as jax_ncnn
from litepi_tpu_torch.weights import fold_bn as port_fold
from litepi_tpu_torch.weights import ncnn_import as port_ncnn
from tests import torch_graph_helpers as G
from tests.torch_port_helpers import (
    assert_tree_equal,
    one_torch_thread,  # noqa: F401 (a fixture, used by pytestmark)
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FAMILIES = G.FORMAT_FAMILIES["ncnn"]
SIZE = 64
TOL = 1e-5


@pytest.fixture(scope="module")
def trees():
    return {f: G.family_vars(f, seed=i) for i, f in enumerate(FAMILIES)}


@pytest.mark.parametrize("dtype", ["fp32", "fp16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_ncnn_files_byte_equal_to_jax(trees, tmp_path, family, dtype):
    want = G.emit(G.jax_package(), "ncnn", family, trees[family], str(tmp_path / "jax"), dtype)
    got = G.emit(G.port_package(), "ncnn", family, trees[family], str(tmp_path / "port"), dtype)
    for ext in ("param", "bin"):
        with open(got[ext], "rb") as g, open(want[ext], "rb") as w:
            assert g.read() == w.read(), ext


@pytest.mark.parametrize("family", FAMILIES)
def test_tree_fold_equals_jax(trees, family):
    v = trees[family]
    if family == G.CLASSIFIER:
        want = jax_fold.fold_pipeline_vars(v, eps=1e-5)
        got = port_fold.fold_pipeline_vars(v, eps=1e-5)
    else:
        want = jax_fold.fold_detector_pipeline_vars(v)
        got = port_fold.fold_detector_pipeline_vars(v)
    assert got[1] is want[1] is True
    assert_tree_equal(got[0], want[0])
    # a folded tree passes through, as JAX's
    again, jfused = jax_fold.fold_pipeline_vars(want[0])
    assert port_fold.fold_pipeline_vars(want[0])[1] is jfused
    assert_tree_equal(port_fold.fold_pipeline_vars(want[0])[0], again)


def test_tree_fold_refuses_what_jax_refuses(trees):
    v = trees["yolo_plus_v1"]
    params = dict(v["params"])
    stats = {"lonely": {"bn": {"mean": np.zeros(4, np.float32), "var": np.ones(4, np.float32)}}}
    bad = {"params": params, "batch_stats": {**v["batch_stats"], **stats}}
    with pytest.raises(ValueError) as jerr:
        jax_fold.fold_batchnorm(bad)
    with pytest.raises(ValueError) as perr:
        port_fold.fold_batchnorm_vars(bad)
    assert str(perr.value) == str(jerr.value)
    # bn parameters without statistics: the unfused form, as JAX says
    no_stats = {"params": v["params"]}
    assert port_fold.fold_pipeline_vars(no_stats)[1] is jax_fold.fold_pipeline_vars(no_stats)[1]


@pytest.fixture(scope="module")
def graphs(trees, tmp_path_factory):
    """{family: (parsed layers with weights, image (3, SIZE, SIZE))} of the
    port's fp32 emission at SIZE."""
    root = str(tmp_path_factory.mktemp("ncnn"))
    out = {}
    for i, f in enumerate(FAMILIES):
        p = G.emit(G.port_package(), "ncnn", f, trees[f], root, "fp32", SIZE)
        layers = port_ncnn.parse_ncnn_param(p["param"])
        port_ncnn.read_ncnn_bin(layers, p["bin"])
        img = np.random.default_rng(i).uniform(0, 1, (3, SIZE, SIZE)).astype(np.float32)
        out[f] = layers, img
    return out


@pytest.mark.parametrize("family", ["yolov11n", G.CLASSIFIER])
def test_run_ncnn_graph_matches_jax_interpreter(graphs, family):
    layers, img = graphs[family]
    want = jax_ncnn.run_ncnn_graph(layers, img)
    got = port_ncnn.run_ncnn_graph(layers, img, device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    assert G.rel_err(got, want) <= TOL


@pytest.mark.parametrize("family", FAMILIES)
def test_run_ncnn_graph_matches_the_port_model(trees, graphs, family):
    layers, img = graphs[family]
    got = port_ncnn.run_ncnn_graph(layers, img, device="cpu")
    want = G.port_graph_output(G.port_model(family, trees[family]), img,
                               detector=family != G.CLASSIFIER)
    assert got.shape == want.shape
    assert G.rel_err(got, want) <= TOL


def test_run_ncnn_graph_blobs_and_device(graphs):
    layers, img = graphs["yolo_plus_v1"]
    blobs = port_ncnn.run_ncnn_graph(layers, img, return_blobs=True, device="cpu")
    assert all(isinstance(b, np.ndarray) for b in blobs.values())
    np.testing.assert_array_equal(blobs["out0"], port_ncnn.run_ncnn_graph(layers, img, device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_ncnn.run_ncnn_graph(layers, img)
