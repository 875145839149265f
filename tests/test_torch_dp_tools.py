"""The data-parallel tools on the CPU (``litepi_tpu_torch/tools/
{dp_cards,mesh_serve}.py``): without the cards their ranks need, both
exit with rc 2 and one ``error:`` line, never running on fewer cards or
on the CPU; ``dp_cards``' parser reads the training CLI's own epoch lines
(loss, seconds, validation seconds), and its host data pipeline timing
runs the CLI's dataset at the global batch over its synthetic JPEGs."""

import numpy as np
import pytest

from litepi_tpu_torch.tools import dp_cards, mesh_serve
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("tool", [dp_cards, mesh_serve], ids=["dp_cards", "mesh_serve"])
def test_without_the_cards_exits_2(tool, capsys):
    assert tool.main(["--ranks", "2"]) == 2
    err = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("error")]
    assert len(err) == 1 and "visible CUDA devices" in err[0], err


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    return dp_cards.write_images(str(tmp_path_factory.mktemp("dp_cards") / "data"), 4,
                                 np.random.default_rng(0))


def test_epoch_lines_of_the_cli_parse(images, tmp_path, capsys):
    from litepi_tpu_torch.apps.train_detector import main

    img_dir, lbl_dir = images
    assert main(["--images", img_dir, "--labels", lbl_dir, "--imgsz", "64", "--batch", "2",
                 "--steps_per_epoch", "1", "--epochs", "2", "--max_gt", "8", "--patience",
                 "99", "--device", "cpu", "--output", str(tmp_path / "out")]) == 0
    rows = dp_cards.EPOCH_LINE.findall(capsys.readouterr().out)
    assert [int(r[0]) for r in rows] == [1, 2]
    assert all(np.isfinite(float(v)) for r in rows for v in r[1:])


def test_data_pipeline_timing(images):
    import os

    img_dir, lbl_dir = images
    assert len(os.listdir(img_dir)) == len(os.listdir(lbl_dir)) == 4
    assert dp_cards.data_seconds_per_batch(img_dir, lbl_dir, 1) > 0
