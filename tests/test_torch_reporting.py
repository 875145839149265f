"""The port's results analyser (``litepi_tpu_torch.bench.reporting``) and
report CLI (``litepi_tpu_torch.apps.report``) against the JAX package's,
mirroring tests/test_reporting.py: on the same summary CSV both write the
same LaTeX table and summary report, and the same figures where matplotlib
is present; without matplotlib (the card's machine has none) the port
draws no figure and still writes the table and the summary."""

import csv
import os
import sys

import pytest

from litepi_tpu.apps import report as jax_report
from litepi_tpu.bench.reporting import ResultsAnalyzer as JaxAnalyzer
from litepi_tpu_torch.apps import report as port_report
from litepi_tpu_torch.bench.reporting import ResultsAnalyzer

FIGURE_INPUTS = dict(
    stage_ms={
        "shufflenetv2": {"detect": 10, "crop": 3, "classify": 4},
        "resnet18": {"detect": 10, "crop": 3, "classify": 9},
    },
    samples_ms={"shufflenetv2": [19, 20, 21, 25], "resnet18": [30, 31, 35]},
    usage={
        "shufflenetv2": {"cpu_percent": 40.0, "memory_mb": 900.0},
        "resnet18": {"cpu_percent": 45.0, "memory_mb": 1100.0},
    },
)


@pytest.fixture()
def summary_csv(tmp_path):
    p = tmp_path / "comparison_summary.csv"
    p.write_text(
        "model_combination,detector,classifier,num_test_images,"
        "mean_precision,mean_recall,mean_f1,fps,mAP50,mAP50-95\n"
        "yolo_plus_v2+shufflenetv2,yolo_plus_v2,shufflenetv2,0,,,,0.0,0.0,0.0\n"
        "yolo_plus_v2+shufflenetv2,yolo_plus_v2,shufflenetv2,3019,"
        "0.88,0.81,0.84,5046.4,0.8081,0.5958\n"
        "yolo_plus_v2+resnet18,yolo_plus_v2,resnet18,3019,"
        "0.89,0.81,0.84,3200.0,0.8247,0.6113\n"
    )
    return str(p)


def test_analyzer_full_flow_matches_jax(summary_csv, tmp_path):
    got = ResultsAnalyzer(summary_csv, str(tmp_path / "port"))
    want = JaxAnalyzer(summary_csv, str(tmp_path / "jax"))
    # the empty warmup row (num_test_images=0) is dropped, as the reference does
    assert len(got.df) == len(want.df) == 2
    assert got.df.equals(want.df)
    paths = got.generate_all_figures(**FIGURE_INPUTS)
    want_paths = want.generate_all_figures(**FIGURE_INPUTS)
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in want_paths]
    assert len(paths) == 5
    for p in paths:
        assert os.path.exists(p) and os.path.getsize(p) > 0
    for name in ("comparison_table.tex", "summary_report.txt"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    tex = (tmp_path / "port" / "comparison_table.tex").read_text()
    assert "\\begin{tabular}" in tex and "yolo\\_plus\\_v2+shufflenetv2" in tex
    report = (tmp_path / "port" / "summary_report.txt").read_text()
    assert "fastest: yolo_plus_v2+shufflenetv2" in report
    assert "most accurate: yolo_plus_v2+resnet18" in report


def test_without_matplotlib_no_figures(summary_csv, tmp_path, monkeypatch):
    """matplotlib missing: every figure function returns None, the table
    and the summary are written as with it."""
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    a = ResultsAnalyzer(summary_csv, str(tmp_path / "nofig"))
    assert a.generate_all_figures(**FIGURE_INPUTS) == []
    assert a.plot_fps_comparison() is None
    assert sorted(os.listdir(tmp_path / "nofig")) == ["comparison_table.tex",
                                                      "summary_report.txt"]


def test_report_cli_matches_jax(summary_csv, tmp_path, capsys):
    """The CLI over an eval output directory with the side files the e2e
    CLI writes: the same summary and files as the JAX CLI; rc 2 without a
    summary CSV."""
    src = os.path.dirname(summary_csv)
    combo = "yolo_plus_v2+shufflenetv2"
    os.makedirs(os.path.join(src, combo))
    for side, row in (("usage", {"cpu_percent": 40.0, "memory_mb": 900.0}),
                      ("stages", {"detect": 10.0, "classify": 4.0})):
        with open(os.path.join(src, combo, f"{combo}_{side}.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(list(row))
            w.writerow(list(row.values()))
    outs = {}
    for name, main in (("jax", jax_report.main), ("port", port_report.main)):
        outs[name] = tmp_path / f"fig_{name}"
        assert main(["--input", src, "--output", str(outs[name])]) == 0
        outs[name + "_text"] = capsys.readouterr().out
    assert sorted(os.listdir(outs["port"])) == sorted(os.listdir(outs["jax"]))
    assert "latency_breakdown.png" in os.listdir(outs["port"])
    assert "resource_utilization.png" in os.listdir(outs["port"])
    assert (outs["port_text"].replace(str(outs["port"]), "OUT")
            == outs["jax_text"].replace(str(outs["jax"]), "OUT"))
    assert port_report.main(["--input", str(tmp_path / "nothing")]) == 2


def test_environment_report_in_torch_terms():
    """``bench/envinfo.py``: the JAX report's host fields, equal on the same
    host, with torch / CUDA / cuDNN and the cards in place of JAX's device
    terms (none here: no card, no power limit)."""
    import torch

    from litepi_tpu.bench.envinfo import environment_report as jax_report
    from litepi_tpu_torch.bench.envinfo import environment_report

    got, want = environment_report(), jax_report()
    for k in ("python", "platform", "processor", "ram_gb", "cpus", "native_loader"):
        assert got[k] == want[k], k
    assert not {"jax", "flax", "backend"} & set(got)
    assert got["torch"] == torch.__version__
    assert got["device_count"] == torch.cuda.device_count()
    if not torch.cuda.is_available():
        assert got["devices"] == [] and "nvidia_smi" not in got
