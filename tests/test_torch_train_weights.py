"""Trained weights leave the port as Flax-named trees
(``weights/jax_bridge.py::state_dict_to_jax``), and a training run
persists and resumes (``weights/checkpoint.py::save_train_checkpoint`` /
``load_train_checkpoint``).

* ``state_dict_to_jax(jax_to_state_dict(v)) == v`` bit for bit for every
  family's JAX variables (the detectors, the zoo, the four classifiers),
  with BatchNorm and folded, and the port's model loads each state
  strictly (tolerance: none);
* a training checkpoint restores the model, the optimizer state, the step,
  the EMA and the meta exactly, promotes a ``.old`` left by a crash
  between the swap's renames, and refuses an orbax directory.
"""

import os

import numpy as np
import pytest
import torch

from litepi_tpu.models import YoloLitePi as JaxYolo
from litepi_tpu.models import build_classifier as jax_build
from litepi_tpu.models.yolov5 import YoloV5 as JaxV5
from litepi_tpu.models.yolov11 import YoloV11 as JaxV11
from litepi_tpu.weights.fold_bn import fold_pipeline_vars
from litepi_tpu_torch.core import types as T
from litepi_tpu_torch.models import YoloLitePi, YoloV5, YoloV11, build_classifier
from litepi_tpu_torch.weights.checkpoint import (
    load_train_checkpoint,
    save_checkpoint,
    save_train_checkpoint,
)
from litepi_tpu_torch.weights.jax_bridge import jax_to_state_dict, state_dict_to_jax
from tests.torch_port_helpers import assert_tree_equal, random_jax_vars
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CLASSIFIERS = ("shufflenetv2", "resnet18", "mobilenetv2", "efficientnet")


def _family(name):
    """(JAX model, port model) of a family, BatchNorm unfused."""
    from litepi_tpu.core import types as JT

    if name in ("yolo_plus_v2", "yolo_plus_v1", "yolov8n"):
        jcfg = {"yolo_plus_v2": JT.YOLO_PLUS_V2, "yolo_plus_v1": JT.YOLO_PLUS_V1,
                "yolov8n": JT.YOLOV8N}[name]
        pcfg = {"yolo_plus_v2": T.YOLO_PLUS_V2, "yolo_plus_v1": T.YOLO_PLUS_V1,
                "yolov8n": T.YOLOV8N}[name]
        return JaxYolo(jcfg), YoloLitePi(pcfg)
    if name == "yolov11n":
        return JaxV11(num_classes=3), YoloV11(num_classes=3)
    if name in ("yolov5n", "yolov5n_legacy"):
        af = name == "yolov5n"
        return JaxV5(num_classes=3, anchor_free=af), YoloV5(num_classes=3, anchor_free=af)
    return jax_build(name, 10), build_classifier(name, 10)


@pytest.mark.parametrize("family", ["yolo_plus_v2", "yolo_plus_v1", "yolov8n", "yolov11n",
                                    "yolov5n", "yolov5n_legacy", *CLASSIFIERS])
def test_state_dict_to_jax_inverts_the_bridge(family):
    jmodel, pmodel = _family(family)
    v = random_jax_vars(jmodel, seed=1, spatial=64)
    sd = jax_to_state_dict(v)
    pmodel.load_state_dict(sd)  # strict: every key maps
    back = state_dict_to_jax(pmodel.state_dict())
    assert_tree_equal(back, v)


@pytest.mark.parametrize("family", ["yolo_plus_v2", "shufflenetv2", "resnet18"])
def test_folded_trees_round_trip(family):
    """Deploy-form (BatchNorm folded) trees: biased convs and no
    ``batch_stats``."""
    jmodel, _ = _family(family)
    v = random_jax_vars(jmodel, seed=2, spatial=64)
    eps = 1e-5 if family in CLASSIFIERS else 1e-3
    folded, fused = fold_pipeline_vars(v, eps=eps)
    assert fused and "batch_stats" not in folded
    back = state_dict_to_jax(jax_to_state_dict(folded))
    assert_tree_equal(back, {"params": folded["params"]})


def _state(tmp_seed=0):
    from litepi_tpu_torch.train.detector import create_detector_train_state

    cfg = T.ablation_configs(width_scales=(0.25,), extra=())[0]
    return create_detector_train_state(cfg, seed=tmp_seed, dtype=torch.float32, device="cpu")


def test_train_checkpoint_round_trip(tmp_path):
    model, state, tx = _state(0)
    with torch.no_grad():  # move every part of the state off its init
        for p in model.parameters():
            p.add_(0.5)
        for t in state.opt_state["trace"]:
            t.fill_(0.25)
        for e in state.ema_params.values():
            e.fill_(-1.0)
        for m in model.modules():
            if hasattr(m, "running_var"):
                m.running_var.fill_(2.0)
    state.step = 17
    path = str(tmp_path / "resume")
    meta = {"next_epoch": 3, "best_score": 0.25, "best_epoch": 1}
    save_train_checkpoint(path, state, meta)
    save_train_checkpoint(path, state, meta)  # a second save swaps in place
    assert sorted(os.listdir(tmp_path)) == ["resume"]
    fresh_model, fresh, _ = _state(1)
    restored, got_meta = load_train_checkpoint(path, fresh, meta_template={"next_epoch": 0,
                                                                          "best_score": 0.0})
    assert got_meta == {"next_epoch": 3, "best_score": 0.25}
    assert restored.step == 17
    for a, b in zip(fresh_model.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(restored.opt_state["trace"], state.opt_state["trace"]):
        assert torch.equal(a, b)
    for k in state.ema_params:
        assert torch.equal(restored.ema_params[k], state.ema_params[k])
    _, all_meta = load_train_checkpoint(path, _state(2)[1])
    assert all_meta == meta


def test_train_checkpoint_promotes_old_and_refuses_orbax(tmp_path):
    _, state, _ = _state(0)
    path = str(tmp_path / "resume")
    save_train_checkpoint(path, state, {"next_epoch": 1})
    os.rename(path, path + ".old")  # a crash between the swap's two renames
    _, meta = load_train_checkpoint(path, _state(0)[1])
    assert meta == {"next_epoch": 1} and os.path.isdir(path) and not os.path.isdir(path + ".old")
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax"):
        load_train_checkpoint(str(orbax), _state(0)[1])
    other = tmp_path / "best"
    save_checkpoint(str(other), {"params": {"w": np.zeros(2, np.float32)}})
    with pytest.raises(ValueError, match="not a training checkpoint"):
        load_train_checkpoint(str(other), _state(0)[1])
