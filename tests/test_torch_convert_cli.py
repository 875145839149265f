"""The port's convert CLI (``litepi_tpu_torch.apps.convert``) against the
JAX package's (``litepi_tpu.apps.convert``) on the same argv (the port's
plus ``--device cpu``): detector inputs; the classifier, the default
output and the error paths are in tests/test_torch_convert_cli_classifier.py.

Inputs are artifacts both read: a yolo_plus_v2 NCNN pair and a yolov11n
OpenVINO IR written by the JAX emitters from seeded variables.  Each
emission (``--emit ncnn`` in fp32 and fp16, ``onnx``, ``openvino``) gives
the same rc, the same files byte for byte (``metadata.yaml`` without its
``date:`` line) and smoke samples within 1e-3; the yolov11n IR's emissions
(the CLI's variant paths) equal what the JAX CLI writes, made from the JAX
importer and emitter.  Unsupported emissions give rc 2 and the same
stderr on both sides.
"""

import os
import re

import numpy as np
import pytest
import torch

from litepi_tpu.apps.convert import main as jax_main
from litepi_tpu_torch.apps.convert import main as port_main
from tests import torch_graph_helpers as G
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("inputs"))
    jax_pkg = G.jax_package()
    det = G.emit(jax_pkg, "ncnn", "yolo_plus_v2", G.family_vars("yolo_plus_v2", 3), root)
    v11 = G.emit(jax_pkg, "openvino", "yolov11n", G.family_vars("yolov11n", 4), root)
    return {"det": det["param"], "v11": v11["xml"], "root": root}


def _run(main, argv, out, capsys, extra=()):
    rc = main([*argv, "--output", out, *extra])
    captured = capsys.readouterr()
    return rc, captured.out, captured.err


def _both(argv, tmp_path, capsys, jax_input=None, port_input=None):
    """(JAX (rc, stdout, stderr, output), port (...)) of one argv; each side
    takes its own ``--input`` where given."""
    res = []
    for side, main, extra, inp in (("jax", jax_main, (), jax_input),
                                   ("port", port_main, ("--device", "cpu"), port_input)):
        out = str(tmp_path / side)
        args = list(argv) + (["--input", inp] if inp else [])
        res.append((*_run(main, args, out, capsys, extra), out))
    return res


def _sample(stdout):
    return np.array([float(v) for v in re.search(r"smoke sample=\[(.*)\]", stdout)
                     .group(1).split(",")])


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                data = f.read()
            if n == "metadata.yaml":
                data = b"\n".join(line for line in data.split(b"\n")
                                  if not line.startswith(b"date:"))
            out[os.path.relpath(path, root)] = data
    return out


EMISSIONS = [
    ("det", "yolo_plus_v2", ["--emit", "ncnn"]),
    ("det", "yolo_plus_v2", ["--emit", "ncnn", "--emit_dtype", "fp16"]),
    ("det", "yolo_plus_v2", ["--emit", "onnx"]),
    ("det", "yolo_plus_v2", ["--emit", "openvino", "--emit_input_size", "320"]),
]


@pytest.mark.parametrize("src, arch, emit", EMISSIONS)
def test_emission_matches_jax_cli(inputs, tmp_path, capsys, src, arch, emit):
    argv = ["--arch", arch, "--num_classes", "1", "--input", inputs[src],
            "--input_size", "64", *emit]
    (jrc, jout, jerr, jdir), (prc, pout, perr, pdir) = _both(argv, tmp_path, capsys)
    assert jrc == prc == 0, (jerr, perr)
    want, got = _files(jdir), _files(pdir)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    np.testing.assert_allclose(_sample(pout), _sample(jout), atol=1e-3, rtol=0)


@pytest.mark.parametrize("emit", ["ncnn", "openvino"])
def test_variant_emission_matches_jax_emitter(inputs, tmp_path, capsys, emit):
    """The yolov11n IR through the port's CLI (its variant paths), against
    what the JAX CLI writes there: the JAX importer's variables through the
    JAX emitter (numpy; the JAX CLI's own run is left out for its model
    compile), and the JAX CLI's sidecars."""
    from litepi_tpu.apps import convert as jax_convert
    from litepi_tpu.weights import openvino_import as jax_ov

    argv = ["--arch", "yolov11n", "--num_classes", "1", "--input", inputs["v11"],
            "--input_size", "64", "--emit", emit]
    out = str(tmp_path / "port")
    rc, stdout, err = _run(port_main, argv, out, capsys, ("--device", "cpu"))
    assert rc == 0, err
    assert np.isfinite(_sample(stdout)).all()
    v = jax_ov.convert_detector_openvino_variant(inputs["v11"], inputs["v11"][:-4] + ".bin",
                                                 "yolov11n", 1)
    want_dir = str(tmp_path / "jax")
    os.makedirs(want_dir)
    pkg = G.jax_package()
    args = jax_convert.argparse.Namespace(arch="yolov11n", num_classes=1, input=inputs["v11"],
                                          output=want_dir, input_size=64, emit_input_size=640)
    if emit == "ncnn":
        pkg["ncnn"].export_detector_ncnn_variant(
            v, "yolov11n", os.path.join(want_dir, "model.ncnn.param"),
            os.path.join(want_dir, "model.ncnn.bin"))
        jax_convert._write_ncnn_smoke_script(args)
    else:
        pkg["openvino"].export_detector_openvino_variant(
            v, "yolov11n", os.path.join(want_dir, "model.xml"),
            os.path.join(want_dir, "model.bin"))
    jax_convert._write_ncnn_metadata(args, None)
    assert _files(out) == _files(want_dir)


@pytest.mark.parametrize("arch, emit", [("resnet18", "ncnn"), ("yolov5n", "onnx"),
                                        ("mobilenetv2", "openvino")])
def test_unsupported_emission_matches_jax_cli(tmp_path, capsys, arch, emit):
    argv = ["--arch", arch, "--num_classes", "3", "--input", "x.pth", "--emit", emit]
    (jrc, _, jerr, _), (prc, _, perr, _) = _both(argv, tmp_path, capsys)
    assert jrc == prc == 2
    assert perr == jerr
