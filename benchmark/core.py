"""What every cell shares: finding its files by name, the spans the
benchmark records around its calls into the program, the device trace
and its reduction, and the device's description for the result line.

Every unit a later change may add is a file of its own, found by the
name `BENCHMARK.json` gives it:

    benchmark/workloads/<cell>.json     configuration, traffic, chips, limits
    benchmark/configs/<config>.json     the model as it is run
    benchmark/traffic/<mix>.json        the traffic's parameters, and its
                                        generator's name
    benchmark/traffic/<generator>.py    a load generator and the entry the
                                        window drives (class Traffic)
    benchmark/metrics/<metric>.py       a per-layer metric's reader
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "libreasr_tpu")


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (the port's name only begins with it)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Spans:
    """Host time in the benchmark's own spans around its calls into the
    program: totals by name. While a trace runs, each span is also a
    profiler range, so that the trace can say what the host was doing in
    a gap on the device."""

    def __init__(self):
        self.total: dict[str, float] = {}
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.profiling:
            import torch
            with torch.profiler.record_function("bm:" + name):
                yield
        else:
            yield
        self.total[name] = self.total.get(name, 0.0) + time.perf_counter() - t0


class Tracer:
    """A `torch.profiler` trace over part of the window, from `start_at`
    to `stop_at` (host clock): the device is drained at both ends, so
    that what the trace holds is exactly the work enqueued between
    them. The traffic's loop calls `poll()`, and `stop()` when the window
    closes, each with the counters (`marks`) read at both ends."""

    def __init__(self, spans: Spans, start_at: float, stop_at: float):
        self.spans = spans
        self.start_at, self.stop_at = start_at, stop_at
        self.prof = None
        self.t0 = self.t1 = None
        self.done = False
        self.marks: dict[str, tuple] = {}
        self.overhead_s = 0.0  # host time spent starting and stopping it

    def poll(self, now: float, marks: dict | None = None) -> None:
        import torch
        if self.done:
            return
        if self.prof is None and now >= self.start_at:
            # the work in flight runs to its end first: it is the
            # window's, and the time spent starting the profiler is not
            torch.cuda.synchronize()
            t = time.perf_counter()
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            self.spans.profiling = True
            self.marks = {k: (v, None) for k, v in (marks or {}).items()}
            self.t0 = time.perf_counter()
            self.overhead_s += self.t0 - t
            # the stretch runs its full length from the trace's start
            self.stop_at = self.t0 + (self.stop_at - self.start_at)
        elif self.prof is not None and now >= self.stop_at:
            self.stop(marks)

    def stop(self, marks: dict | None = None) -> None:
        import torch
        if self.prof is None or self.done:
            return
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.spans.profiling = False
        self.prof.__exit__(None, None, None)
        self.overhead_s += time.perf_counter() - self.t1
        self.marks = {k: (v0, (marks or {}).get(k))
                      for k, (v0, _) in self.marks.items()}
        self.done = True

    def summary(self) -> dict:
        """busy_s (device time covered by any operation), window_s,
        kernel_s (summed kernel time), the device operations by time
        and the longest idle gaps by the span the host was in."""
        from torch.autograd import DeviceType
        if not self.done:
            return {}
        dev, host = [], []
        for e in self.prof.events():
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                # the spans' own ranges are mirrored on the device's
                # timeline: annotations, not work
                if not e.name.startswith("bm:"):
                    dev.append((tr.start, tr.end, e.name))
            elif e.name.startswith("bm:"):
                host.append((tr.start, tr.end, e.name[3:]))
        dev.sort()
        host.sort()
        by_name: dict[str, float] = {}
        kernel_us = 0.0
        for s, e, n in dev:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
            if not n.lower().startswith("memcpy") and not n.lower().startswith("memset"):
                kernel_us += e - s
        busy, gaps = 0.0, []
        cur_s = cur_e = None
        for s, e, _ in dev:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((s - cur_e, cur_e))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        gaps.sort(reverse=True)
        labelled = []
        for length, at in gaps[:10]:
            what = "outside the benchmark's spans"
            for s, e, n in host:
                if s <= at <= e:
                    what = n
            labelled.append([what, length / 1e6])
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy / 1e6, "window_s": self.t1 - self.t0,
                "kernel_s": kernel_us / 1e6, "n_device_ops": len(dev),
                "device_ops": [[n, t / 1e6] for n, t in ops],
                "idle_gaps": labelled, "marks": self.marks}


def device_info(chips: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or
    'not read'."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"
