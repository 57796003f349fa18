"""Nothing the benchmark runs imports JAX, flax or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the plain reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

from benchmark import core

BANNED = {"jax", "jaxlib", "flax", "libreasr_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _files(sub=""):
    for d, _, fs in os.walk(os.path.join(core.HERE, sub)):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _files():
        for name in _imports(path):
            assert name.split(".")[0] not in BANNED, (path, name)


def test_reference_imports_nothing_of_the_port():
    for path in _files("reference"):
        for name in _imports(path):
            assert name.split(".")[0] != "libreasr_tpu_torch", (path, name)


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "from benchmark.tests.tiny import tiny_bench;"
            "from benchmark import core;"
            "d = tiny_bench('stream-beam4lm-backlog', 32, gain=16.0, bias=14.0).generator();"
            "d.setup(); d.window(1.5); d.release(); d.judge_numbers();"
            "print(core.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "stream-greedy-backlog", "--seed", "1", "--seconds", "1"],
        cwd=core.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "{" not in out.stdout
