"""The per-layer readers of the program's own spans and counters
(libreasr_tpu_torch.telemetry): each reads a number from the registry a
tiny backlog window on the CPU filled, None from an empty registry, and
names the layer and the metric it moves as the manifest does."""

import threading
import time

import pytest

from benchmark import core
from benchmark.tests.tiny import tiny_bench
from libreasr_tpu_torch import telemetry

READERS = ("stage_ms.backlog", "churn_ms.backlog", "row_fill_pct.backlog",
           "gap_ms.backlog")
CELLS = {"stream-greedy-backlog": dict(bias=17.0, gain=16.0, compute="float32"),
         "stream-beam4lm-backlog": dict(bias=14.0, gain=16.0, compute="float32")}
SEED = 32


@pytest.mark.parametrize("name", READERS)
def test_reader_matches_the_manifest(name):
    entry = {x["name"]: x for x in core.manifest()["per_layer"]}[name]
    reader = core.load_module("metrics", name)
    assert (reader.LAYER, reader.MOVES) == (entry["layer"], entry["moves"])
    assert entry["workloads"] == sorted(CELLS, reverse=True)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_readers_read_a_tiny_window(cell):
    bench = tiny_bench(cell, SEED, **CELLS[cell])
    drv = bench.generator()
    drv.setup()
    telemetry.enable(False)
    telemetry.reset()
    try:
        with telemetry.tracing():
            drv.window(1.0)
        # the card's idle gaps come from CUDA events; on the CPU one
        # stands in for them
        telemetry.gap(0.001, time.perf_counter_ns(), threading.get_ident())
        ctx = {"counters": drv.counters, "spans": bench.spans,
               "trace": {"busy_s": 0.5, "window_s": 1.0,
                         "marks": {"replays": (0, 0)}},
               "config": bench.config, "traffic": bench.traffic,
               "device_name": "cpu"}
        got = {name: core.load_module("metrics", name).read(ctx)
               for name in READERS}
        c = drv.counters
        steps = telemetry.snapshot()["counters"]["engine.steps"]
        assert steps == c["engine_steps"]
        for name, v in got.items():
            assert isinstance(v, float) and v >= 0, (name, v)
        assert got["stage_ms.backlog"] > 0
        assert got["churn_ms.backlog"] > 0
        assert got["row_fill_pct.backlog"] == pytest.approx(
            100.0 * c["slot_steps"] / (c["engine_steps"] * bench.traffic["streams"]),
            rel=1e-12)
        assert got["gap_ms.backlog"] == pytest.approx(1.0 / steps, rel=1e-9)
        telemetry.reset()
        for name in READERS:
            assert core.load_module("metrics", name).read(ctx) is None, name
    finally:
        telemetry.reset()
