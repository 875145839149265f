"""The port's data-parallel serving (``litepi_tpu_torch/pipeline/
serving.py::MeshServer``, ``StreamingRunner(server=...)``) at 2 gloo ranks
on the CPU against the JAX package's single-device ``run_fused``.

A tiny config at 64x64 (tests/test_serving.py's tolerance: floats within
1e-4, discrete outputs equal) whose classifier budget binds: 10 crops of
the batch's 11 valid detections, 5 on the first rank's two frames and 6 on
the second's, so the global top-k takes 4 of one rank's and 6 of the
other's.  The detector's class head is scaled up (x3000) so that the
scores spread and the threshold sits in a gap far wider than the two
frameworks' float noise.  The indivisible batch raises ``ValueError`` on
every rank; ``serve_local`` + ``gather`` equals ``serve``; a stream through
the server equals the stream without one.  A slow case holds the port's
2 ranks against JAX's own ``MeshServer`` over ``make_mesh(2, backend=
"cpu")``.
"""

import numpy as np
import pytest

from litepi_tpu.core.types import DetectorConfig, NMSConfig, PipelineConfig
from litepi_tpu.pipeline import TwoStagePipeline as JaxPipeline
from litepi_tpu_torch.parallel.multiprocess import spawn_ranks
from tests.torch_dp_workers import stream
from tests.torch_port_helpers import jax_init_vars, one_torch_thread, port_config  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = PipelineConfig(
    detector=DetectorConfig(name="tiny", base_channels=(32, 64, 128, 256, 512), input_size=64),
    nms=NMSConfig(max_candidates=64, max_detections=8, min_area=0.0),
    det_input_size=64,
    cls_input_size=32,
    num_classifier_classes=7,
    cls_crop_budget=10,
)
CONF = 0.53  # in the gap (0.5127, 0.5558) of the scene's detection scores
EXACT = ("valid", "det_class_ids", "cls_labels")
LIMIT = 120.0


@pytest.fixture(scope="module")
def scene():
    det, clf = jax_init_vars(CFG, 0)
    head = det["params"]["head"]
    for i in range(3):
        head[f"cls{i}_out"] = dict(head[f"cls{i}_out"], kernel=head[f"cls{i}_out"]["kernel"] * 3000.0)
    frames = np.random.default_rng(3).integers(0, 256, (4, 64, 64, 3), np.uint8)
    want = {k: np.asarray(v) for k, v in JaxPipeline(CFG, det, clf).run_fused(frames, CONF).items()}
    return det, clf, frames, want


@pytest.fixture(scope="module")
def served(scene):
    det, clf, frames, _ = scene
    return spawn_ranks("tests.torch_dp_workers:serve", 2,
                       {"cfg": port_config(CFG), "det_vars": det, "cls_vars": clf,
                        "frames": frames, "conf": CONF},
                       device="cpu", timeout=LIMIT, threads=1)


def _assert_matches(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k in EXACT:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k].astype(np.float64), want[k].astype(np.float64),
                                       atol=1e-4, rtol=0, err_msg=k)


def test_the_budget_binds_unevenly(scene):
    det, clf, frames, want = scene
    unbudgeted = JaxPipeline(
        PipelineConfig(**{**CFG.__dict__, "cls_crop_budget": 0}), det, clf
    ).run_fused(frames, CONF)
    per_frame = np.asarray(unbudgeted["valid"]).sum(1)
    assert per_frame.tolist() == [2, 3, 3, 3]
    kept = want["valid"].sum(1)
    assert kept.sum() == CFG.cls_crop_budget < per_frame.sum()
    assert kept[:2].sum() == 4 and kept[2:].sum() == 6


def test_two_rank_mesh_server_equals_jax_run_fused(served, scene):
    want = scene[3]
    for rank in served:
        assert rank["data_parallelism"] == 2
        _assert_matches(rank["served"], want)


def test_serve_local_gathered_equals_serve(served):
    for rank in served:
        for k, v in rank["served"].items():
            np.testing.assert_array_equal(rank["local_gathered"][k], v, err_msg=k)


def test_indivisible_batch_raises(served):
    for rank in served:
        assert "batch 3 not divisible by data axis 2" in rank["indivisible"]


def test_streaming_through_the_server_equals_direct_stream(scene):
    det, clf, frames, _ = scene
    geoms = np.tile(np.array([0.5, 0.0, 20.0, 128.0, 88.0], np.float32), (6, 1))
    frames6 = np.concatenate([frames, frames[:2]])
    kw = {"cfg": port_config(CFG), "det_vars": det, "cls_vars": clf, "frames": frames6,
          "geoms": geoms, "conf": CONF, "batch_size": 4}
    direct = stream(**kw, with_server=False)  # in this process, without a mesh
    for streamed in spawn_ranks("tests.torch_dp_workers:stream", 2, kw, device="cpu",
                                timeout=LIMIT, threads=1):
        assert [p for p, _ in streamed] == [p for p, _ in direct]
        assert [len(p) for p, _ in streamed] == [4, 2]
        for (_, got), (_, want) in zip(streamed, direct):
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.slow
def test_two_rank_mesh_server_equals_jax_mesh_server(served, scene):
    from litepi_tpu.parallel import make_mesh
    from litepi_tpu.pipeline.serving import MeshServer

    det, clf, frames, _ = scene
    server = MeshServer(JaxPipeline(CFG, det, clf), make_mesh(2, backend="cpu"))
    want = {k: np.asarray(v) for k, v in server.serve(frames, CONF).items()}
    for rank in served:
        _assert_matches(rank["served"], want)
