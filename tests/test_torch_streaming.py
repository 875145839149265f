"""The port's streaming entry point (litepi_tpu_torch/pipeline/streaming.py)
and its native loader binding (litepi_tpu_torch/data/native_loader.py)
against the JAX package's, on the CPU.

Both runners get the same pre-letterboxed canvases and loader geoms from
an in-memory ``_decode_batch`` (as tests/test_streaming_overlap.py feeds
the JAX one), so the comparison covers the window, the trailing-batch
padding, ``area_scale = 1 / ratio^2`` and the host unmap of the boxes.
The canvases are the SMALL detector's input size, so the port runs its
stem-kernel branch.  Tolerances are run_fused's (tests/test_torch_pipeline
.py), with boxes divided by the letterbox ratio (1e-3 px on the canvas).
"""

import numpy as np
import pytest

from litepi_tpu.data import native_loader as jax_native
from litepi_tpu.pipeline import TwoStagePipeline as JaxPipeline
from litepi_tpu.pipeline.streaming import StreamingRunner as JaxStreamingRunner
from litepi_tpu_torch.data import native_loader
from litepi_tpu_torch.pipeline import StreamingRunner, TwoStagePipeline
from litepi_tpu_torch.pipeline.streaming import area_scale_of, unmap_boxes
from tests.torch_port_helpers import (
    CANVAS_SCENES,
    SMALL,
    canvas_frames,
    jax_init_vars,
    one_torch_thread,  # noqa: F401 (a fixture, used by pytestmark)
    port_config,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CONF = CANVAS_SCENES["rgb"][1]
RATIO = 0.5  # canvases of 320x240 sources: dw 0, dh 20
GEOM = np.array([RATIO, 0.0, 20.0, 320.0, 240.0], np.float32)
EXACT = ("valid", "det_class_ids", "cls_labels")
CLOSE = {"det_scores": 1e-6, "boxes": 1e-3 / RATIO, "cls_probs": 1e-5, "cls_scores": 1e-5}
N_FRAMES, BATCH = 10, 4


def _mem_source(n=N_FRAMES, geom=GEOM):
    """Frame i is canvas i % 2 of the canvas scene; paths name the index."""
    canvases = canvas_frames()
    frames = canvases[np.arange(n) % len(canvases)]
    geoms = np.tile(geom, (n, 1))
    return [f"mem://{i}" for i in range(n)], frames, geoms


def _index(paths):
    return [int(p.rsplit("/", 1)[1]) for p in paths]


class MemJaxRunner(JaxStreamingRunner):
    def __init__(self, pipe, frames, geoms, **kw):
        super().__init__(pipe, use_native_loader=False, **kw)
        self._frames, self._geoms = frames, geoms

    def _decode_batch(self, paths):
        idx = _index(paths)
        return self._frames[idx], self._geoms[idx]


class MemRunner(StreamingRunner):
    def __init__(self, pipe, frames, geoms, **kw):
        super().__init__(pipe, use_native_loader=False, **kw)
        self._frames, self._geoms = frames, geoms

    def _decode_batch(self, paths, out=None):
        idx = _index(paths)
        return self._frames[idx], self._geoms[idx]


@pytest.fixture(scope="module")
def pipelines():
    det, clf = jax_init_vars(SMALL, seed=0)
    port = TwoStagePipeline.from_jax_vars(port_config(SMALL), det, clf, device="cpu")
    return JaxPipeline(SMALL, det, clf), port


def test_streaming_matches_jax(pipelines):
    jp, port = pipelines
    paths, frames, geoms = _mem_source()
    want = list(MemJaxRunner(jp, frames, geoms, batch_size=BATCH).run(paths, CONF))
    got = list(MemRunner(port, frames, geoms, batch_size=BATCH).run(paths, CONF))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert [len(p) for p, _ in got] == [4, 4, 2]  # trailing padding stripped
    assert sum((p for p, _ in got), []) == paths
    n_valid = 0
    for (_, g), (_, w) in zip(got, want):
        assert set(g) == set(w)
        for k in EXACT:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)
        for k, tol in CLOSE.items():
            assert g[k].shape == np.asarray(w[k]).shape, k
            np.testing.assert_allclose(g[k], np.asarray(w[k]), atol=tol, rtol=0, err_msg=k)
        n_valid += int(g["valid"].sum())
        # unmapped into the 320x240 source
        assert (g["boxes"][..., [0, 2]] <= 320).all() and (g["boxes"][..., [1, 3]] <= 240).all()
    assert n_valid > 0


def test_streamed_batch_is_run_fused_plus_host_unmap(pipelines):
    """A streamed batch equals run_fused on its canvases with area_scale =
    1 / ratio^2, then the host unmap."""
    _, port = pipelines
    paths, frames, geoms = _mem_source(n=BATCH)
    (_, got), = MemRunner(port, frames, geoms, batch_size=BATCH).run(paths, CONF)
    direct = port.run_fused(frames, CONF, area_scale=area_scale_of(geoms))
    want = {k: v.numpy() for k, v in direct.items()}
    want["boxes"] = unmap_boxes(want["boxes"], geoms)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(area_scale_of(geoms), np.full(BATCH, 4.0, np.float32))


def test_area_scale_drops_boxes(pipelines):
    """The min-area floor is applied to areas times 1 / ratio^2: a huge
    ratio (area_scale 1e-8) leaves no valid box, and run_fused's own
    area_scale argument does the same."""
    _, port = pipelines
    paths, frames, _ = _mem_source(n=BATCH)
    kept = list(MemRunner(port, frames, np.tile(GEOM, (BATCH, 1)), batch_size=BATCH).run(paths, CONF))
    tiny_geom = GEOM.copy()
    tiny_geom[0] = 1e4
    dropped = list(MemRunner(port, frames, np.tile(tiny_geom, (BATCH, 1)),
                             batch_size=BATCH).run(paths, CONF))
    assert kept[0][1]["valid"].any()
    assert not dropped[0][1]["valid"].any()
    tiny = port.run_fused(frames, CONF, area_scale=np.full(BATCH, 1e-8, np.float32))
    big = port.run_fused(frames, CONF, area_scale=np.full(BATCH, 1e6, np.float32))
    none = port.run_fused(frames, CONF)
    assert not tiny["valid"].any()
    assert big["valid"].sum() >= none["valid"].sum() > 0


def test_window_and_entry_points_on_the_cpu(pipelines):
    """inflight=1 and a window larger than the batch count give the same
    batches; benchmark and benchmark_ram count only real frames."""
    _, port = pipelines
    paths, frames, geoms = _mem_source()
    runs = [list(MemRunner(port, frames, geoms, batch_size=BATCH, inflight=n).run(paths, CONF))
            for n in (1, 8)]
    for (pa, a), (pb, b) in zip(*runs):
        assert pa == pb
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    runner = MemRunner(port, frames, geoms, batch_size=BATCH)
    stats = runner.benchmark(paths, CONF)
    assert stats["frames"] == N_FRAMES and stats["native_decoder"] is False
    ram = runner.benchmark_ram(frames, n_batches=3, conf_threshold=CONF, warmup_batches=1)
    assert ram["frames"] == 3 * BATCH
    with pytest.raises(ValueError, match="frames"):
        runner.benchmark_ram(frames[:2])
    runner.close()


def test_decode_errors_reach_the_caller(pipelines):
    _, port = pipelines

    class Broken(MemRunner):
        def _decode_batch(self, paths, out=None):
            raise OSError("unreadable batch")

    paths, frames, geoms = _mem_source()
    with pytest.raises(OSError, match="unreadable"):
        list(Broken(port, frames, geoms, batch_size=BATCH).run(paths, CONF))


@pytest.fixture(scope="module")
def jpeg_paths(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate([(120, 200), (300, 180), (160, 160), (90, 400), (1080, 720)]):
        img = rng.integers(0, 200, (h, w, 3), dtype=np.uint8)
        img[h // 4 : h // 2, w // 4 : w // 2] = 255
        p = str(root / f"f{i:03d}.jpg")
        cv2.imwrite(p, img)
        paths.append(p)
    bad = root / "broken.jpg"
    bad.write_bytes(b"not a jpeg")
    return paths + [str(bad)]


@pytest.mark.parametrize("scaled_decode", [False, True])
def test_native_loader_matches_jax_binding(jpeg_paths, scaled_decode):
    """Same source, same flags: byte-equal canvases and equal geoms; a
    frame that fails to decode has ratio 0 in both."""
    if not (jax_native.available() and native_loader.available()):
        pytest.skip(f"native loader unavailable: {native_loader.build_error()}")
    a = jax_native.NativeBatchLoader(threads=2, out_size=160, scaled_decode=scaled_decode)
    b = native_loader.NativeBatchLoader(threads=2, out_size=160, scaled_decode=scaled_decode)
    want_c, want_g = a.load(jpeg_paths)
    out = np.empty((len(jpeg_paths), 160, 160, 3), np.uint8)
    got_c, got_g = b.load(jpeg_paths, out=out)
    assert got_c is out
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_g, want_g)
    assert want_g[-1, 0] == 0 and (want_g[:-1, 0] > 0).all()
    with pytest.raises(ValueError, match="C-contiguous"):
        b.load(jpeg_paths, out=out[:, ::2])
    a.close()
    b.close()


def test_native_loader_builds_into_the_port_build_dir():
    if not native_loader.available():
        pytest.skip(f"native loader unavailable: {native_loader.build_error()}")
    path = native_loader.library_path()
    assert path.exists() and path.parent == native_loader.BUILD_DIR
    assert "native" not in path.parent.parts


@pytest.mark.parametrize("use_native", [False, True])
def test_stream_jpegs_order_and_unmap(pipelines, jpeg_paths, use_native):
    """Real files through both loaders: every path once, in order; with the
    native loader, boxes in each source's own pixels."""
    if use_native and not native_loader.available():
        pytest.skip("native loader unavailable")
    _, port = pipelines
    paths = jpeg_paths[:3] if not use_native else jpeg_paths
    if not use_native:  # cv2 batches must share a resolution
        paths = [jpeg_paths[2]] * 3
    runner = StreamingRunner(port, batch_size=2, use_native_loader=use_native)
    seen = []
    for batch_paths, out in runner.run(paths, conf_threshold=0.4):
        seen.extend(batch_paths)
        assert out["boxes"].shape == (len(batch_paths), SMALL.nms.max_detections, 4)
        assert np.isfinite(out["boxes"]).all()
    assert seen == list(paths)
    probe = runner.decode_probe(paths, threads=2)
    assert probe["frames"] == len(paths) and probe["threads"] == (2 if use_native else 1)
    runner.close()
