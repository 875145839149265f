"""The port's data tools (``litepi_tpu_torch.data.audit``,
``apps.data_split``, ``apps.data_audit``) against the JAX package's, on
trees the tests write: the split's file lists and label files, the audit's
report and the CLIs' exit codes and text (mirroring
tests/test_small_tools.py::test_data_split and
tests/test_data.py::test_dataset_audit)."""

import os

import cv2
import numpy as np

from litepi_tpu.apps import data_audit as jax_audit_cli
from litepi_tpu.apps.data_split import build_subset as jax_build_subset
from litepi_tpu.data.audit import audit_dataset as jax_audit
from litepi_tpu.data.audit import format_report as jax_format
from litepi_tpu_torch.apps import data_audit as port_audit_cli
from litepi_tpu_torch.apps import data_split as port_split
from litepi_tpu_torch.data.audit import audit_dataset, format_report


def _tree(root):
    return {p: sorted(os.listdir(os.path.join(root, p))) for p in sorted(os.listdir(root))}


def test_data_split_matches_jax(tmp_path, capsys):
    src_i, src_l = tmp_path / "si", tmp_path / "sl"
    src_i.mkdir()
    src_l.mkdir()
    for i in range(5):
        (src_i / f"im{i}.jpg").write_bytes(b"x")
    (src_i / "notes.txt").write_text("not an image")
    (src_l / "im0.txt").write_text("0 0.5 0.5 0.1 0.1\n")  # only im0 labelled
    for name, fn in (("jax", jax_build_subset), ("port", port_split.build_subset)):
        out = tmp_path / name
        assert fn(str(src_i), str(src_l), str(out / "di"), str(out / "dl"), 3) == 3
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert sorted(os.listdir(tmp_path / "port" / "di")) == ["im0.jpg", "im1.jpg", "im2.jpg"]
    for f in os.listdir(tmp_path / "jax" / "dl"):
        assert ((tmp_path / "port" / "dl" / f).read_text()
                == (tmp_path / "jax" / "dl" / f).read_text())
    # negatives get EMPTY label files (the reference's convention)
    assert (tmp_path / "port" / "dl" / "im1.txt").read_text() == ""
    assert port_split.main(["--src_images", str(src_i), "--src_labels", str(src_l),
                            "--dst_images", str(tmp_path / "cli_i"), "--dst_labels",
                            str(tmp_path / "cli_l"), "--num", "2"]) == 0
    assert "copied 2 image/label pairs" in capsys.readouterr().out


def test_dataset_audit_matches_jax(tmp_path, capsys):
    img_dir, lbl_dir = tmp_path / "img", tmp_path / "lbl"
    img_dir.mkdir()
    lbl_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        cv2.imwrite(str(img_dir / f"a{i}.jpg"), rng.integers(0, 255, (32, 32, 3), np.uint8))
    (img_dir / "bad.jpg").write_bytes(b"not a jpeg")
    (lbl_dir / "a0.txt").write_text("0 0.5 0.5 0.2 0.2\n\n")
    (lbl_dir / "a1.txt").write_text("1 0.5 0.5 0.2 0.2\nmal formed\n0 x 0.5 0.1 0.1\n")
    (lbl_dir / "a2.txt").write_text("0 1.5 0.5 0.2 0.2\n0 0.5 0.5 0.0 0.3\n")
    (lbl_dir / "ghost.txt").write_text("0 0.5 0.5 0.1 0.1\n")  # no image

    for num_classes in (None, 1):
        for check in (True, False):
            rep = audit_dataset(str(img_dir), str(lbl_dir), num_classes, check)
            assert rep == jax_audit(str(img_dir), str(lbl_dir), num_classes, check)
    rep = audit_dataset(str(img_dir), str(lbl_dir), num_classes=1)
    assert not rep["ok"] and rep["num_negatives"] == 1
    assert len(rep["orphan_labels"]) == 1 and len(rep["unreadable_images"]) == 1
    assert len(rep["malformed_lines"]) == 2 and len(rep["out_of_range_lines"]) == 2
    assert len(rep["bad_class_lines"]) == 1 and rep["class_counts"] == {0: 3, 1: 1}
    txt = format_report(rep)
    assert txt == jax_format(rep)
    assert "PROBLEMS FOUND" in txt and "ORPHAN LABELS" in txt

    argv = ["--images", str(img_dir), "--labels", str(lbl_dir), "--num_classes", "1"]
    outs = []
    for main in (jax_audit_cli.main, port_audit_cli.main):
        assert main(argv) == 1
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]

    # a clean dataset passes
    (img_dir / "bad.jpg").unlink()
    (lbl_dir / "ghost.txt").unlink()
    for f in ("a1.txt", "a2.txt"):
        (lbl_dir / f).write_text("0 0.5 0.5 0.2 0.2\n")
    assert port_audit_cli.main(["--images", str(img_dir), "--labels", str(lbl_dir)]) == 0
    assert port_audit_cli.main(["--images", str(img_dir), "--labels", str(lbl_dir),
                                "--skip_decode"]) == 0
    assert capsys.readouterr().out.strip().endswith("OK")
