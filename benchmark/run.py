"""One run of one benchmark cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's files by name, makes the weights and the traffic from
the seed, sets up the program (the PyTorch port) and warms every shape
the cell uses, measures for `--seconds`, then checks what the timed
path served against the plain reference and prints one JSON line last:

    {"correct", "attempted", "failed", "metrics", "device", "check"}

With --trace 0 the metrics are the cell's end-to-end metrics; with
--trace 1 its per-layer metrics, from a torch.profiler trace over part
of the window and the benchmark's own spans and counters, and a
`breakdown` of the device's time. The numbers compared by the check are
printed last on standard error and under "check", each beside its limit.

Exits non-zero, and prints no result, without as many cards as the cell
asks for, or if JAX, flax or the JAX package is loaded once the window
has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from benchmark import core  # noqa: E402

HOST_THREADS = 2

# one process with few threads: the host loop is Python and numpy, and
# spare intra-op threads only contend with it for the host's cores
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, str(HOST_THREADS))

# build and kernel caches at fixed paths inside the checkout, so that a
# cell's later runs find what its first one built
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, os.path.join(core.ROOT, ".bench_cache", _dir))


class Bench:
    """One run's shared state: the cell's files, the seed, the device,
    the weights, and the spans."""

    def __init__(self, workload: str, seed: int, device, config=None,
                 traffic=None, phases=None):
        """config, traffic: dicts in place of the cell's files (the
        calibration and the tests); phases: set-up's phases so far."""
        import torch

        from benchmark import weights as W

        self.workload = workload
        self.cell = core.load_json("workloads", workload)
        self.config = config or core.load_json("configs", self.cell["config"])
        self.traffic = traffic or core.load_json("traffic", self.cell["traffic"])
        self.seed = int(seed)
        self.device = torch.device(device)
        self.spans = core.Spans()
        self.phases: dict[str, float] = dict(phases or {})
        self._t_mark = T_START + sum(self.phases.values())
        self.mark("import")
        torch.empty(1, device=self.device)
        self.mark("context")
        conf = self.config["conf"]
        # a configuration that pins its weights' seed serves one model
        # whatever the run's seed; the run's seed then makes the traffic
        self.weight_seed = int(self.config.get("weight_seed", self.seed))
        self.leaves = W.draw(W.plan(conf), self.weight_seed, self.device,
                             self.config["blank_bias"], self.config.get("gain"))
        self.mark("weights")

    def mark(self, phase: str) -> None:
        """Set-up's host seconds since the last mark, under `phase`."""
        now = time.perf_counter()
        self.phases[phase] = now - self._t_mark
        self._t_mark = now

    def generator(self):
        mod = core.load_module("traffic", self.traffic["generator"])
        return mod.Traffic(self, self.traffic)


def cell_metrics(workload: str, kind: str) -> list[dict]:
    """The manifest's metrics of `kind` that this cell reports."""
    return [m for m in core.manifest()[kind]
            if workload in m.get("workloads", [workload])]


def check(drv, limits: dict) -> tuple[bool, list, list, list]:
    """(correct, [(name, value, limit)], faults, [(name, value)] of the
    numbers read beside them)."""
    nums, faults = drv.judge_numbers()
    rows = [(k, float(nums[k]), float(v)) for k, v in limits.items()]
    ok = not faults and all(v <= lim for _, v, lim in rows)
    info = [(k, nums[k]) for k in nums if k not in limits]
    return ok, rows, faults, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    phases = {"import_torch": time.perf_counter() - T_START}
    torch.set_num_threads(HOST_THREADS)
    cell = core.load_json("workloads", args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    phases["card_check"] = time.perf_counter() - T_START - phases["import_torch"]
    bench = Bench(args.workload, args.seed, "cuda", phases=phases)
    print(f"# card: {core.power_limit()}", file=sys.stderr)
    drv = bench.generator()
    drv.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    print(f"# setup phases (s): {json.dumps(bench.phases)}", file=sys.stderr)

    tracer = None
    if args.trace:
        # trace a stretch in the middle of the window
        now = time.perf_counter()
        length = min(2.0, 0.3 * args.seconds)
        start = now + 0.4 * args.seconds
        tracer = core.Tracer(bench.spans, start, start + length)
    e2e = drv.window(args.seconds, tracer)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    bad = core.forbidden_modules()
    if bad:
        print(f"benchmark: loaded once the window closed: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    drv.release()

    t_check = time.perf_counter()
    ok, rows, faults, info = check(drv, cell["limits"])
    check_s = time.perf_counter() - t_check

    device = core.device_info(chips)
    device["memory_peak_bytes"] = int(peak)
    result = {"correct": ok, "attempted": drv.counters["finished"],
              "failed": 0 if ok else 1}
    metrics = {}
    breakdown = None
    if not args.trace:
        e2e["setup_s"] = setup_s
        for m in cell_metrics(args.workload, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        summ = tracer.summary()
        device["busy_s"] = summ["busy_s"]
        device["window_s"] = summ["window_s"]
        ctx = {"counters": drv.counters, "spans": bench.spans, "trace": summ,
               "config": bench.config, "traffic": bench.traffic,
               "device_name": device["kind"]}
        for m in cell_metrics(args.workload, "per_layer"):
            reader = core.load_module("metrics", m["name"])
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = {"device_ops": summ["device_ops"],
                     "idle_gaps": summ["idle_gaps"]}
        print(f"# trace: {summ['n_device_ops']} device operations, busy "
              f"{summ['busy_s']:.6f} s of {summ['window_s']:.6f} s",
              file=sys.stderr)
    result["metrics"] = metrics
    result["device"] = device
    if breakdown is not None:
        result["breakdown"] = breakdown
    print(f"# counters: {json.dumps(drv.counters)}", file=sys.stderr)
    print(f"# spans (s): {json.dumps(bench.spans.total)}", file=sys.stderr)
    for k, v in info:
        print(f"# check info: {k} {v}", file=sys.stderr)
    print(f"# check took {check_s:.3f} s", file=sys.stderr)
    for f in faults:
        print(f"check fault: {f}", file=sys.stderr)
    for name, v, lim in rows:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    result["check"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    bad = core.forbidden_modules()
    if bad:
        print(f"benchmark: loaded by the check: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
