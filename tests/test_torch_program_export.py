"""The port's program export (``litepi_tpu_torch/weights/export.py``,
``torch.export``) against the JAX package's (``weights/export.py``,
StableHLO), on the same seeded variables and inputs, on the CPU.

The exported programs keep JAX's boundary, NHWC float32 in and logits or
``{reg, cls}`` out; the classifier's agrees with JAX's exported program
within 1e-5 relative to the output's largest magnitude, and the bytes
round trip (``export_program`` / ``load_program``) gives eager's outputs
exactly (the detector's eager forward is held against JAX's in
tests/test_torch_models.py).
"""

import numpy as np
import pytest
import torch

from litepi_tpu.core.types import DetectorConfig as JaxDetectorConfig
from litepi_tpu.models import YoloLitePi as JaxYoloLitePi
from litepi_tpu.models import build_classifier as jax_build_classifier
from litepi_tpu.weights import export as jax_export
from litepi_tpu_torch.core.types import DetectorConfig
from litepi_tpu_torch.models import YoloLitePi, build_classifier
from litepi_tpu_torch.weights import export as port_export
from litepi_tpu_torch.weights.jax_bridge import jax_to_state_dict
from tests.torch_graph_helpers import rel_err
from tests.torch_port_helpers import (
    one_torch_thread,  # noqa: F401 (a fixture, used by pytestmark)
    random_jax_vars,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-5
# a narrow detector (tests/torch_port_helpers.py's SMALL widths) at 64 px
TINY = dict(name="tiny", base_channels=(32, 64, 128, 256, 512), input_size=64)


def _x(batch, size, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (batch, size, size, 3)).astype(np.float32)


def test_classifier_program_matches_jax_program():
    """ResNet18 (torch.export traces ShuffleNetV2's channel shuffle several
    times slower; chip_smoke.py exports ShuffleNetV2 on the card)."""
    v = random_jax_vars(jax_build_classifier("resnet18", 10), seed=2)
    x = _x(2, 64)
    want = np.asarray(jax_export.load_program(jax_export.export_classifier(
        "resnet18", v, 10, 64, 2))(x))
    blob = port_export.export_classifier("resnet18", v, 10, 64, 2, device="cpu")
    assert isinstance(blob, bytes)
    got = port_export.load_program(blob)(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 10) and got.dtype == torch.float32
    assert rel_err(got.numpy(), want) <= TOL
    # the round trip is eager's program
    model = build_classifier("resnet18", 10)
    model.load_state_dict(jax_to_state_dict(v))
    with torch.no_grad():
        eager = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert torch.equal(got, eager)


def test_detector_program_round_trip_is_eager():
    """The detector's program (``{reg, cls}`` at JAX's NHWC boundary) runs as
    the port's eager detector, whose forward tests/test_torch_models.py
    holds against the JAX model's."""
    v = random_jax_vars(JaxYoloLitePi(JaxDetectorConfig(**TINY)), seed=3)
    x = torch.from_numpy(_x(1, 64, seed=1))
    got = port_export.load_program(
        port_export.export_detector(YoloLitePi(DetectorConfig(**TINY)), v, 64, 1,
                                    device="cpu"))(x)
    model = YoloLitePi(DetectorConfig(**TINY))
    model.load_state_dict(jax_to_state_dict(v))
    with torch.no_grad():
        want = model.eval()(x.permute(0, 3, 1, 2))
    assert sorted(got) == ["cls", "reg"]
    for k in ("reg", "cls"):
        assert torch.equal(got[k], want[k]), k


def test_export_refuses_an_unknown_arch_and_a_missing_card():
    v = random_jax_vars(jax_build_classifier("shufflenetv2", 3), seed=4)
    with pytest.raises(ValueError, match="unknown classifier arch"):
        port_export.export_classifier("no_such_arch", v, 3, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_export.export_classifier("shufflenetv2", v, 3)
