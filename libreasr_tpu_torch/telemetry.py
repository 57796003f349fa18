"""The port's spans and counters: one in-process registry.

    from libreasr_tpu_torch import telemetry

    with telemetry.span("engine.dispatch", seq):   # a timed range
        ...
    telemetry.count("engine.rows", n)              # a counter
    telemetry.snapshot()   # {"spans": {name: {count, total_s, self_s,
                           #   parents}}, "counters": {name: value}}
    telemetry.export_chrome("trace.json")          # chrome://tracing

    with telemetry.stage("server.transcribe"):     # timed always
        ...
    telemetry.stages()     # {name: (count, total s)}

Tracing is on when any of these holds: `LIBREASR_TRACE=1` was set when
the module was imported, `enable()` was called, the caller is inside
`with tracing():`, or a `torch.profiler` profile is recording (read
from the profiler's Python flag, never by a call into torch). So a
profiled stretch carries the program's spans with no change to its
caller.

Off, `span` and `count` test that flag and return: no clock read, no
allocation, no profiler range. On, a span records its name, its start
and end (`time.perf_counter_ns`), its parent span (per thread), an id
and its thread into a bounded ring of the newest `RING` records, and
adds itself to its name's totals (count, total and self time, and the
total under each parent name); while a profiler records it is also a
profiler range (a function-scope `RecordFunction`, which the profiler
does not mirror onto the card's timeline), so it lies on the
profiler's clock beside the card's kernels. Counters add only while
tracing is on.

`record(name, t0_ns)` adds a span that began earlier, maybe on another
thread (a queue's wait, a stream's final latency): it has no parent and
no profiler range. `gap(seconds, t_end_ns, thread)` adds one idle gap
of the card, measured by the caller on the card's clock, and splits it
over the host interval that ended at `t_end_ns` by the innermost span
the thread was in at each instant (counters `engine.gap` and
`engine.gap.<span>`, `engine.gap.outside` for the rest).

`stage(name)` and `stage_since(name, t0_ns)` time a serving stage
always, tracing or not: two clock reads and a locked add to the stage's
count and total, which `stages()` reads (`ASRServicer.timings`); while
tracing is on a stage is a span too.

One registry serves the process; `reset()` empties its ring, span
totals and counters, and leaves the stage totals.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque

import torch
import torch.autograd.profiler as _prof

RING = 65536  # span records kept, newest last
OUTSIDE = "outside"  # a gap's share outside every program span


class _Span:
    __slots__ = ("reg", "name", "id", "t0", "parent", "depth", "child", "rf")

    def __init__(self, reg, name, id):
        self.reg, self.name, self.id = reg, name, id

    def __enter__(self):
        stack = self.reg._stack()
        self.parent = stack[-1] if stack else None
        self.depth = len(stack)
        self.child = 0
        stack.append(self)
        self.rf = None
        if _prof._is_profiler_enabled:
            # a function-scope range: `record_function`'s user-scope one
            # is mirrored onto the card's timeline over the kernels it
            # launched, which a trace would count as device work
            self.rf = torch._C._profiler._RecordFunctionFast(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        self.reg._stack().pop()
        dur = t1 - self.t0
        parent = self.parent
        if parent is not None:
            parent.child += dur
        self.reg._add_span(self.name, self.t0, t1,
                           None if parent is None else parent.name,
                           self.id, self.depth, dur - self.child)
        return False


_NULL = contextlib.nullcontext()


class Registry:
    """Span totals, counters and the ring of span records."""

    def __init__(self, ring: int = RING):
        self.enabled = False
        self._ring_len = ring
        self._lock = threading.Lock()
        self._local = threading.local()
        self._stages: dict[str, list] = {}  # name -> [count, total ns]
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._ring = deque(maxlen=self._ring_len)
            # name -> [count, total ns, self ns, {parent name: ns}]
            self._spans: dict[str, list] = {}
            self._counters: dict[str, float] = {}

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _add_span(self, name, t0, t1, parent, id, depth, self_ns) -> None:
        dur = t1 - t0
        tid = threading.get_ident()
        with self._lock:
            self._ring.append((name, t0, t1, parent, id, depth, tid))
            tot = self._spans.get(name)
            if tot is None:
                tot = self._spans[name] = [0, 0, 0, {}]
            tot[0] += 1
            tot[1] += dur
            tot[2] += self_ns
            if parent is not None:
                tot[3][parent] = tot[3].get(parent, 0) + dur

    def add_stage(self, name: str, ns: int) -> None:
        with self._lock:
            tot = self._stages.get(name)
            if tot is None:
                tot = self._stages[name] = [0, 0]
            tot[0] += 1
            tot[1] += ns

    def stages(self) -> dict:
        with self._lock:
            return {k: (v[0], v[1] / 1e9) for k, v in self._stages.items()}

    def add(self, name: str, n) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def record(self, name: str, t0_ns: int, id=None) -> None:
        t1 = time.perf_counter_ns()
        # depth -1: not a range of this thread's nesting (gap splits skip it)
        self._add_span(name, t0_ns, t1, None, id, -1, t1 - t0_ns)

    def gap(self, seconds: float, t_end_ns: int, thread: int) -> None:
        b = t_end_ns
        a = b - round(seconds * 1e9)
        ivs = []  # (start, end, depth, name), clipped to [a, b]
        with self._lock:
            for name, s, e, _, _, depth, tid in reversed(self._ring):
                if tid != thread:
                    continue
                if e <= a:
                    break  # one thread's records end in order
                if depth >= 0 and s < b:
                    ivs.append((max(s, a), min(e, b), depth, name))
        if thread == threading.get_ident():
            for sp in self._stack():  # still open: they end after b
                if sp.t0 < b:
                    ivs.append((max(sp.t0, a), b, sp.depth, sp.name))
        share: dict[str, int] = {}

        def credit(name, ns):
            if ns > 0:
                share[name] = share.get(name, 0) + ns

        # one thread's spans nest: a sweep over starts, with a stack of
        # the ranges open at the cursor, credits each instant to the
        # innermost one
        cur, open_ = a, []
        for s, e, _, name in sorted(ivs, key=lambda x: (x[0], x[2])):
            while open_ and open_[-1][0] <= s:
                end, top = open_.pop()
                credit(top, end - cur)
                cur = max(cur, end)
            credit(open_[-1][1] if open_ else OUTSIDE, s - cur)
            cur = max(cur, s)
            open_.append((e, name))
        while open_:
            end, top = open_.pop()
            credit(top, end - cur)
            cur = max(cur, end)
        credit(OUTSIDE, b - cur)
        share = share or {OUTSIDE: 1}
        with self._lock:
            c = self._counters
            c["engine.gap"] = c.get("engine.gap", 0) + seconds
            total = sum(share.values())
            for name, ns in share.items():
                key = "engine.gap." + name
                c[key] = c.get(key, 0) + seconds * ns / total

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "spans": {k: {"count": v[0], "total_s": v[1] / 1e9,
                              "self_s": v[2] / 1e9,
                              "parents": {p: ns / 1e9 for p, ns in v[3].items()}}
                          for k, v in self._spans.items()},
                "counters": dict(self._counters),
            }

    def export_chrome(self, path: str) -> None:
        """The ring's spans as complete ("X") events of a Chrome trace,
        the counters under "otherData"."""
        pid = os.getpid()
        with self._lock:
            events = [{"name": name, "ph": "X", "ts": t0 / 1e3,
                       "dur": (t1 - t0) / 1e3, "pid": pid, "tid": tid,
                       "args": {"id": id, "parent": parent}}
                      for name, t0, t1, parent, id, _, tid in self._ring]
            counters = dict(self._counters)
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "otherData": {"counters": counters}}, f, default=str)


_REG = Registry()
_REG.enabled = os.environ.get("LIBREASR_TRACE") == "1"


def on() -> bool:
    """Whether spans and counters record now."""
    return _REG.enabled or _prof._is_profiler_enabled


def span(name: str, id=None):
    """A context manager timing a range; a shared no-op when off."""
    if not (_REG.enabled or _prof._is_profiler_enabled):
        return _NULL
    return _Span(_REG, name, id)


def count(name: str, n=1) -> None:
    if _REG.enabled or _prof._is_profiler_enabled:
        _REG.add(name, n)


def now():
    """The clock in ns when tracing is on, else None: the start of a span
    that `record` closes later."""
    if _REG.enabled or _prof._is_profiler_enabled:
        return time.perf_counter_ns()
    return None


def record(name: str, t0_ns, id=None) -> None:
    """Close a span that began at `t0_ns` (from `now()`); nothing when
    t0_ns is None or tracing is off."""
    if t0_ns is not None and (_REG.enabled or _prof._is_profiler_enabled):
        _REG.record(name, t0_ns, id)


def gap(seconds: float, t_end_ns: int, thread: int) -> None:
    """Add one idle gap of the card, whether tracing is on or not: the
    caller measured it because tracing was on when its chains went out."""
    _REG.gap(seconds, t_end_ns, thread)


class _Stage:
    """`stage`'s context: timed always, and a span while tracing is on."""

    __slots__ = ("name", "sp", "t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.sp = span(self.name)
        self.sp.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        _REG.add_stage(self.name, time.perf_counter_ns() - self.t0)
        return self.sp.__exit__(*exc)


def stage(name: str):
    """A serving stage: its count and total always, a span when on."""
    return _Stage(name)


def stage_since(name: str, t0_ns: int) -> None:
    """Close a stage that began at `t0_ns` (`time.perf_counter_ns()`)."""
    _REG.add_stage(name, time.perf_counter_ns() - t0_ns)
    record(name, t0_ns)


def stages() -> dict:
    """Each stage's count and total seconds since the process began."""
    return _REG.stages()


def enable(flag: bool = True) -> None:
    """Tracing on (or off, with False) until changed."""
    _REG.enabled = bool(flag)


@contextlib.contextmanager
def tracing():
    """Tracing on inside the block, as it was after."""
    was = _REG.enabled
    _REG.enabled = True
    try:
        yield
    finally:
        _REG.enabled = was


def snapshot() -> dict:
    return _REG.snapshot()


def reset() -> None:
    _REG.reset()


def export_chrome(path: str) -> None:
    _REG.export_chrome(path)
