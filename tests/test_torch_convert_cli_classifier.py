"""The port's convert CLI against the JAX package's on the same argv (the
port's plus ``--device cpu``), with a classifier input and checkpoints:
the helpers and the detector inputs are tests/test_torch_convert_cli.py's.

A torchvision-keyed ShuffleNetV2 ``.pth`` through ``--emit ncnn``,
``onnx`` and ``openvino``: the same rc, the same files byte for byte
(``metadata.yaml`` without its ``date:`` line) and smoke samples within
1e-3.  The default output is the port's checkpoint where the JAX CLI
writes orbax, with the same tree; that orbax directory as the port's
``--input`` exits with rc 2 and ``load_checkpoint``'s message.  The
wrong-arch and unfoldable paths give rc 2 and the same key words on stderr
on both sides (their inputs hold one tree in each package's checkpoint
format).  Without a card the port's CLI raises unless given ``--device
cpu``.
"""

import os

import numpy as np
import pytest
import torch

from litepi_tpu.weights import checkpoint as jax_ckpt
from litepi_tpu_torch.apps.convert import main as port_main
from litepi_tpu_torch.weights import checkpoint as port_ckpt
from tests import torch_graph_helpers as G
from tests.test_torch_convert_cli import _both, _files, _run, _sample
from tests.torch_port_helpers import (
    assert_tree_equal,
    one_torch_thread,  # noqa: F401 (a fixture, used by pytestmark)
)
from tests.torch_refs import ShuffleNetV2T

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NC = 10


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("inputs"))
    torch.manual_seed(0)
    net = ShuffleNetV2T(num_classes=NC)
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.1, 0.1)
            m.running_var.uniform_(0.5, 1.5)
    pth = os.path.join(root, "shufflenetv2.pth")
    torch.save(net.state_dict(), pth)
    return {"cls": pth}


@pytest.mark.parametrize("emit", ["ncnn", "onnx", "openvino"])
def test_classifier_emission_matches_jax_cli(inputs, tmp_path, capsys, emit):
    argv = ["--arch", "shufflenetv2", "--num_classes", str(NC), "--input", inputs["cls"],
            "--emit", emit]
    (jrc, jout, jerr, jdir), (prc, pout, perr, pdir) = _both(argv, tmp_path, capsys)
    assert jrc == prc == 0, (jerr, perr)
    want, got = _files(jdir), _files(pdir)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    np.testing.assert_allclose(_sample(pout), _sample(jout), atol=1e-3, rtol=0)


def test_default_output_is_the_port_checkpoint(inputs, tmp_path, capsys):
    """JAX writes orbax, the port its checkpoint, with the same tree;
    ``--emit orbax`` is the port's alias; JAX's orbax directory as the
    port's input exits with rc 2 and load_checkpoint's message."""
    argv = ["--arch", "shufflenetv2", "--num_classes", str(NC), "--input", inputs["cls"]]
    (jrc, jout, _, jdir), (prc, pout, _, pdir) = _both(argv, tmp_path, capsys)
    assert jrc == prc == 0
    assert_tree_equal(port_ckpt.load_checkpoint(pdir), jax_ckpt.load_checkpoint(jdir))
    np.testing.assert_allclose(_sample(pout), _sample(jout), atol=1e-3, rtol=0)
    alias = str(tmp_path / "alias")
    assert _run(port_main, [*argv, "--emit", "orbax"], alias, capsys, ("--device", "cpu"))[0] == 0
    assert_tree_equal(port_ckpt.load_checkpoint(alias), port_ckpt.load_checkpoint(pdir))
    rc, _, err = _run(port_main, ["--arch", "shufflenetv2", "--num_classes", str(NC),
                                  "--input", jdir, "--emit", "ncnn"],
                      str(tmp_path / "again"), capsys, ("--device", "cpu"))
    assert rc == 2 and "orbax checkpoint" in err and err.startswith("error:")


def _checkpoints(tmp_path, tree):
    """The same tree as a JAX orbax checkpoint and a port checkpoint."""
    j, p = str(tmp_path / "orbax_in"), str(tmp_path / "port_in")
    jax_ckpt.save_checkpoint(j, tree)
    port_ckpt.save_checkpoint(p, tree)
    return j, p


@pytest.mark.parametrize("case", ["wrong_arch", "unfoldable"])
def test_error_paths_match_jax_cli(tmp_path, capsys, case):
    if case == "wrong_arch":  # classifier weights, a detector arch
        tree = G.family_vars("shufflenetv2", 5)
        argv = ["--arch", "yolov8n", "--num_classes", "1"]
        words = "converted variables do not fit"
    else:  # BatchNorm parameters without their statistics
        tree = {"params": G.family_vars("yolo_plus_v1", 6)["params"]}
        argv = ["--arch", "yolo_plus_v1", "--num_classes", "1", "--emit", "ncnn"]
        words = "error:"
    j, p = _checkpoints(tmp_path, tree)
    (jrc, _, jerr, _), (prc, _, perr, _) = _both(argv + ["--input_size", "64"], tmp_path,
                                                 capsys, jax_input=j, port_input=p)
    assert jrc == prc == 2
    assert words in jerr and words in perr
    assert jerr.startswith("error:") and perr.startswith("error:")


def test_port_cli_runs_on_the_card_unless_asked_for_the_cpu(inputs, tmp_path):
    """``--device`` defaults to ``cuda`` and raises without a card, as
    ``apps/e2e.py`` does; it never falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_main(["--arch", "shufflenetv2", "--num_classes", str(NC), "--input", inputs["cls"],
                   "--output", str(tmp_path / "out")])
