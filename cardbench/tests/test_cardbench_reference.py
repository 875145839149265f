"""The plain reference agrees with the program's ``run_fused`` on the CPU
(the kernels' plain versions run there) in float32, at the configurations'
published widths and a batch of two frames, for both configurations and
for letterboxed frames; and it imports nothing of the program."""

import ast

import pytest
import torch

from cardbench import judge, program, spec, traffic
from cardbench.reference.two_stage import Reference
from cardbench.weights import make_states


def outputs_of_both(config_name, h, w, seed=11):
    cfg = spec.resolve({"litepi-v2-shufflenetv2": "litepi-v2.card-b256",
                        "yolo11n-resnet18": "yolo11n-resnet18.card-b256"}[config_name]).config
    cfg = dict(cfg, serving=dict(cfg["serving"], dtype="float32"))
    det, cls = make_states(cfg, seed, "cpu")
    frames = traffic.make_frames(seed, 0, 2, h, w, "cpu")
    run_fused = program.build(cfg, det, cls, 2, "cpu")
    ref = Reference(cfg, det, cls, "cpu")
    return frames, {k: v for k, v in run_fused(frames).items()}, ref


@pytest.mark.parametrize("config_name,h,w", [
    ("litepi-v2-shufflenetv2", 640, 640),
    ("litepi-v2-shufflenetv2", 1080, 1920),
    ("yolo11n-resnet18", 640, 640),
])
def test_reference_pipeline_matches_run_fused_in_float32(config_name, h, w):
    torch.manual_seed(0)
    frames, got, ref = outputs_of_both(config_name, h, w)
    want = ref.run_pipeline(frames)
    assert torch.equal(got["valid"], want["valid"])
    assert bool(want["valid"].any())
    v = want["valid"]
    assert torch.allclose(got["boxes"][v], want["boxes"][v], atol=2e-2)
    assert torch.allclose(got["det_scores"], want["det_scores"], atol=1e-4)
    assert torch.allclose(got["cls_probs"][v], want["cls_probs"][v], atol=1e-4)
    assert torch.equal(got["cls_labels"][v], want["cls_labels"][v])
    numbers = judge.gaps(ref, [(frames, got)])
    assert numbers["box"] < 0.05 and numbers["score"] < 1e-4
    assert numbers["choice"] < 1e-3 and numbers["prob"] < 1e-3


def test_reference_imports_nothing_of_the_program():
    for path in (spec.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("litepi_tpu_torch", "litepi_tpu", "jax"), (path, n)
