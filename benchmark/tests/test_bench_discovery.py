"""A new cell, configuration, traffic mix or per-layer metric is found by
its name, from files alone, with no edit to the harness."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import cells, harness

ROOT = Path(__file__).resolve().parents[2]


def _copy_benchmark(tmp: Path) -> dict:
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for sub in ("configs", "traffic", "limits", "metrics", "modes"):
        shutil.copytree(ROOT / "benchmark" / sub, tmp / "benchmark" / sub)
    return json.loads((tmp / "BENCHMARK.json").read_text())


def test_every_committed_cell_resolves():
    bench = cells.load_benchmark(ROOT)
    for w in bench["workloads"]:
        cell = cells.find_cell(w["name"], ROOT)
        mode = cells.load_mode(cell, ROOT)
        assert callable(mode.run) and callable(mode.control)
        assert cell.limits
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(harness.reader(m["name"], ROOT))


def test_new_cell_config_traffic_and_metric_by_files_alone(tmp_path):
    bench = _copy_benchmark(tmp_path)
    here = tmp_path / "benchmark"
    config = json.loads((here / "configs" / "mvsdet_scannet.json")
                        .read_text())
    config["name"] = "mvsdet_scannet_copy"
    (here / "configs" / "mvsdet_scannet_copy.json").write_text(
        json.dumps(config))
    traffic = json.loads((here / "traffic" / "predict.json").read_text())
    traffic["pool"] = 2
    traffic["mode"] = "replay"
    (here / "traffic" / "predict_two.json").write_text(json.dumps(traffic))
    (here / "modes" / "replay.py").write_text(
        "def run(*args, **kwargs):\n    return 'replayed'\n")
    (here / "limits" / "copy_predict.json").write_text(
        json.dumps({"limits": {"render_gap": 1.0}}))
    (here / "metrics" / "items.predict.py").write_text(
        "def read(ctx):\n    return float(ctx['items'])\n")
    bench["configs"].append(dict(bench["configs"][0],
                                 name="mvsdet_scannet_copy",
                                 file="benchmark/configs/"
                                      "mvsdet_scannet_copy.json"))
    bench["workloads"].append({"name": "copy_predict",
                               "config": "mvsdet_scannet_copy",
                               "traffic": "predict_two", "chips": 1,
                               "why": "a copy"})
    bench["per_layer"].append({"name": "items.predict", "unit": "scenes",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves":
                               "predict_scenes_per_s",
                               "workloads": ["copy_predict"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"].startswith("predict_"):
            m["workloads"].append("copy_predict")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.find_cell("copy_predict", tmp_path)
    assert cell.config["name"] == "mvsdet_scannet_copy"
    assert cell.traffic["pool"] == 2
    assert cell.limits == {"render_gap": 1.0}
    assert {m["name"] for m in cell.end_to_end} == {
        "predict_scenes_per_s", "predict_p90_ms", "setup_s"}
    assert [m["name"] for m in cell.per_layer] == ["items.predict"]
    assert harness.reader("items.predict", tmp_path)({"items": 3}) == 3.0
    assert cells.load_mode(cell, tmp_path).run() == "replayed"


def test_config_file_builds_both_packages_configs():
    from benchmark.reference import config as ref_config
    from mvsdet_torch import config as port_config
    for name, preset in (("mvsdet_scannet", "scannet_config"),
                         ("mvsdet_arkit", "arkit_config")):
        values = json.loads((ROOT / "benchmark" / "configs" /
                             f"{name}.json").read_text())["config"]
        assert cells.build_config(port_config, values) == \
            getattr(port_config, preset)()
        assert cells.build_config(ref_config, values) == \
            getattr(ref_config, preset)()


def test_configuration_files_state_source_and_precision():
    for path in sorted((ROOT / "benchmark" / "configs").glob("*.json")):
        c = json.loads(path.read_text())
        assert c["reduced"] == [] and c["assumed"]
        assert len(c["source"]) <= 200
        assert c["dtype"] == "float32" and c["tf32"] is False
