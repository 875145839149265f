"""A whole run on the CPU at a small batch: the result line's keys, the
traced line's breakdown, no JAX loaded, and the command's refusal
without a card."""

import json
import subprocess
import sys

import pytest

from cardbench import harness
from cardbench.tests.conftest import ROOT, small_cell

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def test_result_line_has_the_contract_keys():
    out = harness.run(small_cell("litepi-v2.card-b256", 2), 2**31 + 11, 1.0, False, device="cpu")
    result = out["result"]
    assert set(result) == KEYS
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
    assert result["device"]["count"] == 1 and "memory_peak_bytes" in result["device"]
    assert result["correct"] is True
    json.dumps(result)


def test_traced_line_has_the_breakdown_and_per_layer_metrics():
    out = harness.run(small_cell("yolo11n-resnet18.card-b256", 2), 5, 1.0, True, device="cpu")
    result = out["result"]
    assert set(result) == KEYS | {"breakdown"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert {"step_mfu.batch", "device_idle.batch"} <= set(result["metrics"])
    assert "frames_per_s" not in result["metrics"]


def test_info_line_times_each_phase_of_set_up():
    out = harness.run(small_cell("litepi-v2.card-b256", 2), 6, 0.5, False, device="cpu")
    phases = out["info"]["setup_phases_s"]
    assert list(phases) == ["device", "weights", "program", "frames", "warmup", "pace"]
    assert sum(phases.values()) <= out["info"]["setup_s"] + 1e-6


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from cardbench import harness\n"
            "from cardbench.tests.conftest import small_cell\n"
            "harness.run(small_cell('yolo11n-resnet18.card-b256', 2), 3, 0.5, False, device='cpu')\n"
            "print(harness.forbidden_modules())\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "litepi_tpu_torch_like", sys)
    assert "litepi_tpu_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in harness.forbidden_modules()


def test_command_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "cardbench", "--workload", "litepi-v2.card-b256",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=str(ROOT), timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_on_the_card_one_cell_runs_correct(cuda):
    out = subprocess.run([sys.executable, "-m", "cardbench", "--workload", "litepi-v2.card-b256",
                          "--seed", "4242424242", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=str(ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
