"""Spawn a group of gloo ranks of tests/helpers/torch_dist_worker.py and
read their results. Every group has its own file:// store and a time
limit, so a hung rank fails its test and nothing else."""

import json
import os
import subprocess
import sys

WORKER = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(WORKER)))


def run_ranks(tmp_path, spec: dict, world: int, timeout: float = 120.0):
    """Run `spec` on `world` ranks; returns (per-rank results, out dir)."""
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    spec = {**spec, "world": world, "store": str(tmp_path / "store"),
            "out": str(out)}
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    env = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen([sys.executable, WORKER, str(path), str(r)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(world)], out
