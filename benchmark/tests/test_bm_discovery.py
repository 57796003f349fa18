"""A configuration, a traffic mix, a cell and a per-layer metric dropped
into a copy of the benchmark are found by name, with no file edited."""

import importlib.util
import json
import shutil


def test_new_files_are_found_by_name(tmp_path):
    from benchmark import core

    root = tmp_path / "checkout"
    shutil.copytree(core.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads(open(core.ROOT + "/BENCHMARK.json").read())
    b = root / "benchmark"
    (b / "configs" / "extra-config.json").write_text(json.dumps(
        {"source": "x", "reduced": [], "conf": {}, "blank_bias": 1.0}))
    (b / "traffic" / "extra-mix.json").write_text(json.dumps(
        {"generator": "backlog", "streams": 3}))
    (b / "workloads" / "extra-cell.json").write_text(json.dumps(
        {"config": "extra-config", "traffic": "extra-mix", "chips": 1,
         "why": "x", "limits": {}}))
    (b / "metrics" / "extra_metric.extra-cell.py").write_text(
        "LAYER = 'x'\nMOVES = 'rt_streams'\n\ndef read(ctx):\n    return 42.0\n")
    manifest["workloads"].append({"name": "extra-cell", "config": "extra-config",
                                  "traffic": "extra-mix", "chips": 1, "why": "x"})
    manifest["per_layer"].append({"name": "extra_metric.extra-cell", "unit": "%",
                                  "better": "higher", "source": "program_counter",
                                  "layer": "x", "moves": "rt_streams",
                                  "workloads": ["extra-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    spec = importlib.util.spec_from_file_location("copied_core", b / "core.py")
    copied = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copied)
    cell = copied.load_json("workloads", "extra-cell")
    assert copied.load_json("configs", cell["config"])["blank_bias"] == 1.0
    assert copied.load_json("traffic", cell["traffic"])["streams"] == 3
    per_layer = [x for x in copied.manifest()["per_layer"]
                 if "extra-cell" in x.get("workloads", ["extra-cell"])]
    assert [x["name"] for x in per_layer] == ["extra_metric.extra-cell"]
    reader = copied.load_module("metrics", per_layer[0]["name"])
    assert reader.read({}) == 42.0
