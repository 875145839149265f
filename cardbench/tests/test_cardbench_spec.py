"""Every cell resolves to its files by name, and a cell added as files
only is found without an edit to any file that is there."""

import json
import shutil

import pytest

from cardbench import judge, spec


def test_every_cell_resolves_to_its_files():
    bench = spec.load_benchmark()
    assert bench["workloads"]
    for w in bench["workloads"]:
        cell = spec.resolve(w["name"], bench)
        assert cell.config["name"] == w["config"]
        assert w["chips"] == 1
        assert cell.limits and set(cell.limits) <= set(judge.NUMBERS)
        assert "stray" in cell.limits
        names = {m["name"] for m in cell.end_to_end}
        assert {"setup_s", "frames_per_s"} <= names
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert callable(spec.reader(m["name"]))
            assert m["moves"] in names


def test_config_files_are_the_benchmark_entries():
    bench = spec.load_benchmark()
    for c in bench["configs"]:
        path = spec.ROOT / c["file"]
        body = json.loads(path.read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]


def test_a_cell_added_as_files_is_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "cardbench")
    bench = spec.load_benchmark()
    here = root / "cardbench"
    (here / "traffic" / "card-b64.json").write_text(json.dumps(
        dict(json.loads((here / "traffic" / "card-b256.json").read_text()), batch=64)))
    (here / "limits" / "litepi-v2.card-b64.json").write_text(
        (here / "limits" / "litepi-v2.card-b256.json").read_text())
    (here / "metrics" / "launch_share.batch.py").write_text("def read(run):\n    return 1.0\n")
    bench["workloads"].append({"name": "litepi-v2.card-b64", "config": "litepi-v2-shufflenetv2",
                               "traffic": "card-b64", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "launch_share.batch", "unit": "%", "better": "lower",
                               "source": "program_counter", "layer": "Entry",
                               "moves": "frames_per_s", "workloads": ["litepi-v2.card-b64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.resolve("litepi-v2.card-b64", here=here)
    assert cell.traffic["batch"] == 64
    assert [m["name"] for m in cell.per_layer] == ["launch_share.batch"]
    assert spec.reader("launch_share.batch", here=here)({}) == 1.0


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.resolve("no-such-cell")
