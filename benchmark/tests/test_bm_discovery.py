"""A configuration, a traffic mix, a cell, a per-layer metric and a
model family dropped into a copy of the benchmark are found by name,
with no file edited."""

import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import core


def test_new_files_are_found_by_name(tmp_path):
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


# A family under a new model name that takes the LSTM transducer's
# architecture through imports, as a variant of it would.
TOY_FAMILY = '''"""The LSTM transducer under another model name."""

from benchmark import core

_T = core.load_module("families", "Transducer")
BLANK_LEAF = _T.BLANK_LEAF
plan, build, reference = _T.plan, _T.build, _T.reference
geometry, flops, tiny = _T.geometry, _T.flops, _T.tiny
'''

# run from the copy's root, so that `benchmark` is the copy's
TOY_RUN = '''
import json
import benchmark
from benchmark import core
from benchmark.tests.tiny import tiny_bench

bench = tiny_bench("toy-cell", 32, bias=17.0, gain=16.0, compute="float32")
drv = bench.generator()
drv.setup()
drv.window(1.0)
drv.release()
nums, faults = drv.judge_numbers()
mfu = core.load_module("metrics", "mfu.backlog").read(
    {"counters": drv.counters, "config": bench.config,
     "device_name": "NVIDIA H100 80GB HBM3"})
print(json.dumps({"package": benchmark.__file__, "family": bench.family.__file__,
                  "nums": nums, "faults": faults, "mfu": mfu,
                  "finished": drv.counters["finished"]}))
'''


def _digests(root):
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_a_new_family_runs_end_to_end_in_a_copy(tmp_path):
    """A family, its configuration, traffic and cell added to a copy of
    the benchmark run a tiny cell on the CPU through set-up, a window,
    release and the check; no file that was there changes."""
    root = tmp_path / "checkout"
    b = root / "benchmark"
    shutil.copytree(core.HERE, b, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), root)
    before = _digests(root)

    (b / "families" / "Toy.py").write_text(TOY_FAMILY)
    config = core.load_json("configs", "rnnt-base-bf16")
    config["conf"]["model"]["name"] = "Toy"
    (b / "configs" / "toy-config.json").write_text(json.dumps(config))
    (b / "traffic" / "toy-mix.json").write_text(
        json.dumps(core.load_json("traffic", "backlog-n512-nb1")))
    (b / "workloads" / "toy-cell.json").write_text(json.dumps(
        {"config": "toy-config", "traffic": "toy-mix", "chips": 1,
         "why": "the LSTM transducer under another name", "limits": {"gap": 0.25}}))

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [core.ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    out = subprocess.run([sys.executable, "-c", TOY_RUN], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["package"] == str(b / "__init__.py")
    assert got["family"] == str(b / "families" / "Toy.py")
    assert got["finished"] > 0 and not got["faults"], got
    assert got["nums"]["tokens"] > 0 and got["nums"]["gap"] < 1e-4, got
    assert got["mfu"] > 0

    after = _digests(root)
    assert {k: after.get(k) for k in before} == before
    assert set(after) - set(before) == {
        "benchmark/families/Toy.py", "benchmark/configs/toy-config.json",
        "benchmark/traffic/toy-mix.json", "benchmark/workloads/toy-cell.json"}


def test_a_model_without_a_family_fails_naming_the_path():
    from benchmark.run import Bench

    config = core.load_json("configs", "rnnt-base-bf16")
    config["conf"]["model"]["name"] = "NoSuchModel"
    with pytest.raises(FileNotFoundError) as err:
        Bench("stream-greedy-backlog", 1, "cpu", config=config)
    assert os.path.join(core.HERE, "families", "NoSuchModel.py") in str(err.value)
