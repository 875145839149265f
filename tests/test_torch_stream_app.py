"""The port's stream app (``litepi_tpu_torch.apps.stream``) against the JAX
package's (``litepi_tpu.apps.stream``), both ``--device cpu``, mirroring
tests/test_stream_app.py: video, folder and single modes, the camera loop
through a fake ``cv2.VideoCapture``, rc 2 for a camera that will not open
and for a missing ``--input``, single mode on graph artifacts, and the
error for a detector artifact that does not load.

Both apps get the same weights as artifacts the JAX emitters write: a
yolo_plus_v2 NCNN pair (tests/test_torch_e2e_cli.py's variables: candidate
scores spread over (0.5, 1)) and a torchvision-keyed ShuffleNetV2 ``.pth``
(its Dense x300: peaked probabilities).  Both run bf16 at a 160 input.  The
CSV rows must agree: frame, class name and the empty placeholder rows
equal, boxes and confidences within the bf16 bounds of
tests/test_torch_bf16_parity.py (JAX's own bf16 drift from its float32
program on the same frames, floored at the float32 parity tolerances).
``--conf`` sits in a gap of the port's candidate scores 2e-3 wide on
either side, far over that drift.  Where every box's integer corners and
every label's two-decimal text agree, the drawn overlays must be the same
pixels.
"""

import csv
import os

import cv2
import numpy as np
import pytest
import torch

from litepi_tpu.apps import stream as jax_stream
from litepi_tpu.core.types import YOLO_PLUS_V2
from litepi_tpu.weights import ncnn_export
from litepi_tpu_torch.apps import stream as port_stream
from tests.test_torch_e2e_cli import _detector_vars
from tests.torch_port_helpers import one_torch_thread, peaked_frames  # noqa: F401
from tests.torch_refs import ShuffleNetV2T

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NUM_CLASSES = 3
FRAME = (200, 320)
VIDEO_FRAMES = 6
COMMON = ["--device", "cpu", "--img_size", "160", "--batch_size", "2", "--max_det", "4",
          "--num_classes", str(NUM_CLASSES), "--clf_arch", "shufflenetv2"]
# the float32 parity tolerances (tests/test_torch_bf16_parity.py's floor)
FLOOR = {"boxes": 1e-3, "det_scores": 1e-6, "cls_scores": 1e-5}
HALF_GAP = 2e-3


def _frames(seed, n):
    return [peaked_frames(seed=seed + i, batch=1, h=FRAME[0], w=FRAME[1])[0] for i in range(n)]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Artifacts, a video, an image folder, the conf threshold and the bf16
    bounds."""
    root = tmp_path_factory.mktemp("stream")
    d = {"param": str(root / "det.param"), "bin": str(root / "det.bin"),
         "pth": str(root / "clf.pth"), "video": str(root / "clip.mp4"),
         "folder": str(root / "imgs")}
    ncnn_export.export_detector_ncnn(_detector_vars(), YOLO_PLUS_V2, d["param"], d["bin"])
    torch.manual_seed(22)
    clf = ShuffleNetV2T(NUM_CLASSES)
    with torch.no_grad():
        clf.fc.weight *= 300.0
    torch.save(clf.state_dict(), d["pth"])
    writer = cv2.VideoWriter(d["video"], cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             (FRAME[1], FRAME[0]))
    for f in _frames(90, VIDEO_FRAMES):
        writer.write(f)
    writer.release()
    os.makedirs(d["folder"])
    for i, f in enumerate(_frames(100, 2)):
        cv2.imwrite(os.path.join(d["folder"], f"i{i}.jpg"), f)

    # what the apps decode: the video's frames and the folder's images
    cap = cv2.VideoCapture(d["video"])
    video = [cap.read()[1] for _ in range(VIDEO_FRAMES)]
    cap.release()
    images = [cv2.imread(os.path.join(d["folder"], f"i{i}.jpg")) for i in range(2)]
    args = port_stream.build_arg_parser().parse_args(_weights(d) + COMMON)
    pipe = port_stream.build_pipeline(args)
    with torch.inference_mode():
        scores = np.concatenate([
            pipe._candidates(pipe._detect(pipe._stem(torch.as_tensor(np.stack(f)))))[1]
            .float().numpy() for f in (video, images)])
    d["conf"] = _conf_in_gap(scores)
    d["bounds"] = _bounds(d, np.stack(video), d["conf"])
    return d


def _weights(d):
    return ["--detector", d["param"], "--classifier", d["pth"]]


def _conf_in_gap(scores):
    """The middle of the widest gap of the candidate scores with 1..3
    scores over it in every frame, at least HALF_GAP wide on either side."""
    flat = np.sort(scores.ravel())[::-1]
    best = None
    for hi, lo in zip(flat[:-1], flat[1:]):
        conf = (float(hi) + float(lo)) / 2
        above = (scores > conf).sum(-1)
        if above.min() >= 1 and above.max() <= 3 and (best is None or hi - lo > 2 * best[1]):
            best = (conf, (float(hi) - float(lo)) / 2)
    assert best is not None and best[1] >= HALF_GAP, best
    return best[0]


def _bounds(d, frames, conf):
    """Each float column's bound: JAX's bf16 drift from its float32 program
    on ``frames`` (valid slots), floored at FLOOR."""
    import jax.numpy as jnp

    from litepi_tpu.core.types import NMSConfig, PipelineConfig
    from litepi_tpu.pipeline.two_stage import TwoStagePipeline
    from litepi_tpu.weights.ncnn_import import convert_detector_ncnn
    from litepi_tpu.weights.torch_import import (
        convert_classifier_state_dict,
        load_torch_state_dict,
    )

    cfg = PipelineConfig(
        detector=YOLO_PLUS_V2, nms=NMSConfig(max_detections=4, max_candidates=256),
        classifier_arch="shufflenetv2", num_classifier_classes=NUM_CLASSES, det_input_size=160,
        batch_size=2, input_color="bgr")
    det = convert_detector_ncnn(d["param"], d["bin"], YOLO_PLUS_V2)[0]
    clf = convert_classifier_state_dict("shufflenetv2", load_torch_state_dict(d["pth"]))
    out = {}
    for dtype in (jnp.bfloat16, jnp.float32):
        res = TwoStagePipeline(cfg, det, clf, dtype=dtype).run_fused(frames, conf)
        out[dtype] = {k: np.asarray(v).astype(np.float32) for k, v in res.items()}
    b16, f32 = out[jnp.bfloat16], out[jnp.float32]
    v = b16["valid"] > 0
    assert v.any() and np.array_equal(v, f32["valid"] > 0)
    return {k: max(float(np.abs(b16[k] - f32[k])[v].max()), FLOOR[k]) for k in FLOOR}


def _run_both(argv_of, tmp_path):
    """Each app's ``main`` on ``argv_of(out_dir)``; returns the out dirs."""
    outs = {}
    for name, main in (("jax", jax_stream.main), ("port", port_stream.main)):
        outs[name] = tmp_path / name
        os.makedirs(outs[name])
        assert main(argv_of(outs[name])) == 0, name
    return outs


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _assert_same_rows(got, want, bounds):
    """CSV rows: header, frames, class names and placeholders equal; boxes
    and confidences within ``bounds``.  Returns whether every drawn label
    and integer corner agrees (the overlays are then the same pixels)."""
    assert got[0] == want[0] == port_stream.CSV_HEADER
    assert len(got) == len(want) > 1
    same_drawing = True
    for g, w in zip(got[1:], want[1:]):
        assert g[0] == w[0] and g[6] == w[6], (g, w)
        if w[1] == "":
            assert g == w  # the placeholder of a frame with no detection
            continue
        for i, key in ((1, "boxes"), (2, "boxes"), (3, "boxes"), (4, "boxes"),
                       (5, "det_scores"), (7, "cls_scores")):
            assert abs(float(g[i]) - float(w[i])) <= bounds[key], (key, g, w, bounds)
        same_drawing &= all(int(float(g[i])) == int(float(w[i])) for i in range(1, 5))
        same_drawing &= all(f"{float(g[i]):.2f}" == f"{float(w[i]):.2f}" for i in (5, 7))
    return same_drawing


def test_video_mode(data, tmp_path):
    outs = _run_both(lambda o: ["--mode", "video", "--input", data["video"], "--save_csv",
                                str(o / "frames.csv"), "--save_video", str(o / "out.mp4"),
                                "--conf", repr(data["conf"]), *_weights(data), *COMMON],
                     tmp_path)
    got, want = _rows(outs["port"] / "frames.csv"), _rows(outs["jax"] / "frames.csv")
    assert {int(r[0]) for r in got[1:]} == set(range(VIDEO_FRAMES))  # every frame has a row
    assert any(r[1] for r in got[1:])
    _assert_same_rows(got, want, data["bounds"])
    cap = cv2.VideoCapture(str(outs["port"] / "out.mp4"))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == VIDEO_FRAMES
    cap.release()


def test_folder_mode(data, tmp_path):
    outs = _run_both(lambda o: ["--mode", "folder", "--input", data["folder"], "--output",
                                str(o), "--conf", repr(data["conf"]), *_weights(data), *COMMON],
                     tmp_path)
    assert sorted(os.listdir(outs["port"])) == ["detections.csv", "i0.jpg", "i1.jpg"]
    same = _assert_same_rows(_rows(outs["port"] / "detections.csv"),
                             _rows(outs["jax"] / "detections.csv"), data["bounds"])
    assert same
    for name in ("i0.jpg", "i1.jpg"):
        np.testing.assert_array_equal(cv2.imread(str(outs["port"] / name)),
                                      cv2.imread(str(outs["jax"] / name)))


def test_single_mode(data, tmp_path, capsys):
    img = os.path.join(data["folder"], "i0.jpg")
    outs = _run_both(lambda o: ["--mode", "single", "--input", img, "--save_image",
                                str(o / "annotated.jpg"), "--conf", repr(data["conf"]),
                                *_weights(data), *COMMON], tmp_path)
    printed = capsys.readouterr().out.splitlines()
    counts = [ln for ln in printed if "detections ->" in ln]
    assert len(counts) == 2 and counts[0].split()[0] == counts[1].split()[0] != "0"
    np.testing.assert_array_equal(cv2.imread(str(outs["port"] / "annotated.jpg")),
                                  cv2.imread(str(outs["jax"] / "annotated.jpg")))


def test_missing_input_errors():
    assert jax_stream.main(["--mode", "video"]) == 2
    assert port_stream.main(["--mode", "video"]) == 2


def test_camera_mode_loop(data, monkeypatch):
    """The camera loop without a camera: a fake ``cv2.VideoCapture`` gives
    3 frames, then stops; each app draws the same overlay on each frame."""
    frames = _frames(110, 3)
    drawn = {}

    class FakeCapture:
        def __init__(self, cam_id):
            assert cam_id == 0
            self._left = [f.copy() for f in frames]
            drawn[self] = self._left[:]

        def isOpened(self):
            return True

        def read(self):
            if not self._left:
                return False, None
            return True, self._left.pop(0)

        def release(self):
            pass

    monkeypatch.setattr(cv2, "VideoCapture", FakeCapture)
    monkeypatch.setattr(cv2, "destroyAllWindows", lambda: None)
    argv = ["--mode", "camera", "--cam_id", "0", "--conf", repr(data["conf"]), *_weights(data),
            *COMMON]
    assert jax_stream.main(argv) == 0
    assert port_stream.main(argv) == 0
    jax_frames, port_frames = drawn.values()
    for j, p, f in zip(jax_frames, port_frames, frames):
        assert not np.array_equal(p, f)  # drawn on: at least the FPS text
        # the same boxes and labels; the FPS text (the top-left band) differs
        np.testing.assert_array_equal(p[40:], j[40:])


def test_camera_mode_unopenable(monkeypatch):
    class Closed:
        def __init__(self, cam_id):
            pass

        def isOpened(self):
            return False

    monkeypatch.setattr(cv2, "VideoCapture", Closed)
    argv = ["--mode", "camera", *COMMON]
    assert jax_stream.main(argv) == 2
    assert port_stream.main(argv) == 2


def test_single_mode_with_graph_artifacts(data, tmp_path, capsys):
    """The exported graphs directly, the reference's full_appv3 pattern
    (ONNX detector :68, classifier sidecar): a JAX-emitted ONNX detector
    and OpenVINO classifier, the same detections on both apps."""
    from litepi_tpu.weights.onnx_export import export_detector_onnx
    from litepi_tpu.weights.openvino_export import export_classifier_openvino
    from litepi_tpu.weights.torch_import import (
        convert_classifier_state_dict,
        load_torch_state_dict,
    )

    onnx_p, xml_p = tmp_path / "det.onnx", tmp_path / "clf.xml"
    export_detector_onnx(_detector_vars(), YOLO_PLUS_V2, str(onnx_p))
    export_classifier_openvino(
        "shufflenetv2",
        convert_classifier_state_dict("shufflenetv2", load_torch_state_dict(data["pth"])),
        NUM_CLASSES, str(xml_p))
    img = os.path.join(data["folder"], "i1.jpg")
    outs = _run_both(lambda o: ["--mode", "single", "--input", img, "--save_image",
                                str(o / "annotated.jpg"), "--detector", str(onnx_p),
                                "--classifier", str(xml_p), "--conf", repr(data["conf"]),
                                *COMMON], tmp_path)
    printed = capsys.readouterr().out.splitlines()
    jax_boxes = [ln for ln in printed if ln.strip().startswith("box ")]
    assert jax_boxes and len(jax_boxes) % 2 == 0
    half = len(jax_boxes) // 2
    for j, p in zip(jax_boxes[:half], jax_boxes[half:]):
        assert j.split("->")[1] == p.split("->")[1]  # class name and cls score
    np.testing.assert_array_equal(cv2.imread(str(outs["port"] / "annotated.jpg")),
                                  cv2.imread(str(outs["jax"] / "annotated.jpg")))


def test_stream_detector_artifact_pointed_error(tmp_path, capsys):
    bad = tmp_path / "det.onnx"
    bad.write_bytes(b"not a protobuf")
    img_path = str(tmp_path / "one.jpg")
    cv2.imwrite(img_path, np.zeros((64, 64, 3), np.uint8))
    for main in (jax_stream.main, port_stream.main):
        rc = main(["--mode", "single", "--input", img_path, "--output", str(tmp_path / "o"),
                   "--detector", str(bad), *COMMON])
        assert rc == 2
        assert "--detector" in capsys.readouterr().err


def test_default_device_needs_a_card(data, monkeypatch):
    """``--device cuda`` is the default: without a card the app raises,
    no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = os.path.join(data["folder"], "i0.jpg")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_stream.main(["--mode", "single", "--input", img])
