"""BENCHMARK.json against its rules, and against the files the harness
finds by the names in it."""

import os
import re

from benchmark import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _m():
    return core.manifest()


def test_names_and_units():
    m = _m()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in m[k]]
    names += [w[k] for w in m["workloads"] for k in ("config", "traffic")]
    names += [k for c in m["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for k in ("end_to_end", "per_layer"):
        assert all(UNIT.match(x["unit"]) for x in m[k])
        assert all(x["better"] in ("lower", "higher") for x in m[k])
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in m[k]}) == len(m[k])


def test_every_per_layer_metrics_cells_report_what_it_moves():
    m = _m()
    cells = [w["name"] for w in m["workloads"]]
    e2e = {x["name"]: x.get("workloads", cells) for x in m["end_to_end"]}
    for x in m["per_layer"]:
        for c in x.get("workloads", cells):
            assert c in cells and c in e2e[x["moves"]], (x["name"], c)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    m = _m()
    for w in m["workloads"]:
        e2e = [x["name"] for x in m["end_to_end"]
               if w["name"] in x.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in x.get("workloads", [w["name"]])
                   for x in m["per_layer"])


def test_configs_have_cells_and_four_chip_cells_are_few():
    m = _m()
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}
    four = sum(w["chips"] == 4 for w in m["workloads"])
    assert four <= max(1, len(m["workloads"]) // 4)
    assert all(w["chips"] in (1, 4) for w in m["workloads"])


def test_bounds():
    m = _m()
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    assert any(x["name"] == "setup_s" for x in m["end_to_end"])


def test_files_agree_with_the_manifest():
    m = _m()
    for c in m["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        conf = core.load_json("configs", c["name"])
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
    for w in m["workloads"]:
        cell = core.load_json("workloads", w["name"])
        for k in ("config", "traffic", "chips", "why"):
            assert cell[k] == w[k], (w["name"], k)
        traffic = core.load_json("traffic", w["traffic"])
        assert os.path.exists(os.path.join(core.HERE, "traffic",
                                           traffic["generator"] + ".py"))
    for x in m["per_layer"]:
        reader = core.load_module("metrics", x["name"])
        assert reader.LAYER == x["layer"] and reader.MOVES == x["moves"]


def test_command_and_paths():
    m = _m()
    assert m["paths"] == ["benchmark"]
    assert 1 <= m["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in m["command"])
