"""The port's classifier training CLI (``litepi_tpu_torch/apps/
train_classifier.py``) against the JAX package's, on the CPU with a tiny
synthetic ImageFolder (the tests/test_train_clis.py pattern): the same argv
(``--device cpu``) gives the same rc and checkpoints of the same Flax
names; a run cut by ``--stop_after 1`` and continued with ``--resume``
ends with the uninterrupted run's weights, training state and dropout
draws, bit for bit (tolerance: none)."""

import os

import numpy as np
import pytest

from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def crops(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("crops")
    rng = np.random.default_rng(1)
    for split in ("train", "val"):
        for ci, c in enumerate(["a", "b", "c"]):
            d = root / split / c
            d.mkdir(parents=True)
            for i in range(4):
                img = np.zeros((32, 32, 3), np.uint8)
                img[:, :, ci] = 200 + rng.integers(0, 50)
                cv2.imwrite(str(d / f"{i}.png"), img)
    return root


def _argv(crops, out, *extra, arch="shufflenetv2"):
    return ["--data", str(crops / "train"), "--val_data", str(crops / "val"), "--arch", arch,
            "--img_size", "32", "--batch", "4", "--steps_per_epoch", "2", "--output", str(out),
            "--device", "cpu", "--patience", "99", *extra]


def test_same_argv_same_rc(crops, tmp_path):
    from litepi_tpu.apps.train_classifier import main as jax_main
    from litepi_tpu.weights.checkpoint import load_checkpoint as jax_load
    from litepi_tpu_torch.apps.train_classifier import main as port_main
    from litepi_tpu_torch.weights.checkpoint import load_checkpoint

    argv = ["--epochs", "1", "--steps_per_epoch", "1"]
    assert jax_main(_argv(crops, tmp_path / "jax", *argv)) == 0
    assert port_main(_argv(crops, tmp_path / "port", *argv)) == 0
    want = jax_load(str(tmp_path / "jax" / "best"))
    got = load_checkpoint(str(tmp_path / "port" / "best"))

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(np.shape(v))
                for k, v in tree.items()}

    assert shapes(got) == shapes(want)
    for main in (jax_main, port_main):
        with pytest.raises(SystemExit) as e:
            main(_argv(crops, tmp_path / "bad", arch="vgg16"))
        assert e.value.code == 2


@pytest.mark.parametrize("arch", ["shufflenetv2", "mobilenetv2"])
def test_resume_equals_uninterrupted(crops, tmp_path, arch):
    """MobileNetV2 trains with dropout: the resumed run draws the
    uninterrupted run's masks (its generator is seeded by (seed, epoch))."""
    from litepi_tpu_torch.apps.train_classifier import main
    from litepi_tpu_torch.weights.checkpoint import load_checkpoint
    from tests.torch_port_helpers import assert_tree_equal

    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    assert main(_argv(crops, straight, "--epochs", "2", arch=arch)) == 0
    assert main(_argv(crops, resumed, "--epochs", "2", "--stop_after", "1", arch=arch)) == 0
    assert main(_argv(crops, resumed, "--epochs", "2", "--resume", arch=arch)) == 0
    assert_tree_equal(load_checkpoint(str(resumed / "best")), load_checkpoint(str(straight / "best")))
    import torch

    a = torch.load(os.path.join(straight, "resume", "variables.pt"), weights_only=True)
    b = torch.load(os.path.join(resumed, "resume", "variables.pt"), weights_only=True)
    assert a["step"] == b["step"] == 4 and a["meta"] == b["meta"]
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for x, y in zip(a["opt_state"]["mu"], b["opt_state"]["mu"]):
        assert torch.equal(x, y)
