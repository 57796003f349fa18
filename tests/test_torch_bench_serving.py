"""The port's serving benchmark (libreasr_tpu_torch/scripts/
bench_serving.py) on the CPU, as tests/test_bench_serving_driver.py
holds the JAX package's: its multi-process load workers against a live
port server on the golden bundle (2 workers x 2 paced clients, their
statistics merged), and the in-process transport, whose result line
has the JAX script's keys plus the transport's name. The benchmark's
own server role and its flagship proxy run only on the card.
"""

import ast
import json
import os
import socket
import subprocess
import sys
import time

import pytest

from libreasr_tpu_torch.api import ASRBundle
from libreasr_tpu_torch.scripts import bench_serving

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden", "model.tar.gz")


def _jax_result_keys() -> set:
    """The keys of the JSON result line of the JAX package's
    scripts/bench_serving.py (its `result = {...}` literal)."""
    tree = ast.parse(open(os.path.join(ROOT, "scripts", "bench_serving.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [getattr(t, "id", None) for t in node.targets] == ["result"]):
            return {k.value for k in node.value.keys}
    raise AssertionError("no result literal in scripts/bench_serving.py")


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    return ASRBundle.from_bundle(GOLDEN, device="cpu",
                                 extract_to=str(tmp_path_factory.mktemp("golden")))


@pytest.fixture(scope="module")
def live_server(golden):
    from libreasr_tpu_torch.models.streaming import StreamingEngine
    from libreasr_tpu_torch.serving.server import make_server

    with socket.socket() as s:
        s.bind(("", 0))
        port = s.getsockname()[1]
    server, servicer = make_server(golden, port,
                                   engine=StreamingEngine(golden, n_streams=8))
    server.start()
    yield port
    server.stop(0)
    servicer.stepper.shutdown()


def test_port_load_workers_merge_against_a_port_server(live_server):
    start_at = time.time() + 8.0  # worker startup (fresh interpreters)
    workers = [
        subprocess.Popen(
            [sys.executable, "-m", "libreasr_tpu_torch.scripts.bench_serving",
             "--role", "load", "--port", str(live_server),
             "--count", "2", "--duration", "2.0",
             "--start-at", repr(start_at), "--seed-base", str(w * 2)],
            cwd=ROOT, stdout=subprocess.PIPE, text=True,
        )
        for w in range(2)
    ]
    merged = []
    for w in workers:
        out, _ = w.communicate(timeout=180)
        assert w.returncode == 0, out[-500:]
        lines = [l for l in out.splitlines() if l.startswith("LOAD ")]
        assert len(lines) == 1
        merged.append(json.loads(lines[0][5:]))
    assert sum(d["n_errors"] for d in merged) == 0, merged
    # every client closed its stream (overrun recorded)
    assert sum(len(d["over"]) for d in merged) == 4
    # latency samples are floats in seconds
    lat = [x for d in merged for x in d["lat"]]
    assert all(0 <= x < 60 for x in lat)


def test_inproc_transport_returns_the_jax_result_keys(golden, monkeypatch):
    monkeypatch.setattr(bench_serving, "_bundle", lambda *a, **k: golden)
    a = bench_serving.parse_args(["--transport", "inproc", "--streams", "3",
                                  "--duration", "1.0"])
    result = bench_serving._bench_inproc(a)
    assert set(result) == _jax_result_keys() | {"transport"}
    assert result["transport"] == "inproc" and result["procs"] == 1
    assert result["n_errors"] == 0, result["errors"]
    assert result["streams"] == 3 and result["overrun_p50_ms"] is not None
    assert result["metric"] == "wire_p50_partial_latency_ms"


def test_inproc_transport_runs_in_one_process():
    a = bench_serving.parse_args(["--transport", "inproc", "--procs", "2"])
    with pytest.raises(ValueError, match="--procs 1"):
        bench_serving._bench_inproc(a)


def test_wire_transport_without_grpc_names_inproc(monkeypatch):
    monkeypatch.setitem(sys.modules, "grpc", None)  # import grpc fails
    with pytest.raises(ImportError, match="--transport inproc"):
        bench_serving._bench_grpc(bench_serving.parse_args([]))
    with pytest.raises(ImportError, match="--transport inproc"):
        bench_serving.run_server(0, 1, 1, 0, 0.0)
