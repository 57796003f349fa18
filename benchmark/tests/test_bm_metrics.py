"""The per-layer readers and what they read: the backlog traffic counts
each slot's buffered samples as the engine holds them, its spans count
from the window's start, the host metric leaves out the host's wait on
the card, and the MFU takes the peak of the configuration's compute
type."""

import numpy as np
import pytest

from benchmark import core
from benchmark import flops as FL
from benchmark.tests.tiny import tiny_bench

CELLS = {"stream-greedy-backlog": dict(bias=17.0, gain=16.0, compute="float32"),
         "stream-beam4lm-backlog": dict(bias=14.0, gain=16.0, compute="float32")}
SEED = 32
H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_backlog_tracks_the_engines_buffers(cell):
    """The samples the traffic counts as buffered are the engine's, at
    every step; its steps in flight are guarded by the beam cell's
    flush, which raises on a close with steps in flight."""
    drv = tiny_bench(cell, SEED, **CELLS[cell]).generator()
    drv.setup()
    closes = len(drv.closed)
    for _ in range(60):
        drv._iteration()
        held = np.array([len(v) for v in drv.eng.sample_buf])
        assert np.array_equal(drv._fill(), held)
    assert len(drv.closed) > closes  # the churn ran under the check


def test_spans_count_from_the_windows_start():
    bench = tiny_bench("stream-greedy-backlog", SEED,
                       **CELLS["stream-greedy-backlog"])
    drv = bench.generator()
    drv.setup()
    assert sum(bench.spans.total.values()) > 0  # the warm loop's
    drv.window(1.0)
    assert 0 < sum(bench.spans.total.values()) <= drv.counters["window_s"]
    assert set(bench.phases) == {"import", "context", "weights", "bundle",
                                 "engine", "warm_loop"}


def test_host_metric_leaves_out_the_wait():
    reader = core.load_module("metrics", "host_ms_per_step.backlog")
    spans = core.Spans()
    spans.total.update(append=1.0, dispatch=2.0, collect=0.5, churn=0.5, wait=9.0)
    assert reader.read({"counters": {"engine_steps": 1000}, "spans": spans}) == 4.0
    assert reader.read({"counters": {}, "spans": spans}) is None


@pytest.mark.parametrize("cell,kind", [("stream-greedy-backlog", "bfloat16"),
                                       ("stream-beam4lm-backlog", "float32")])
def test_mfu_takes_the_peak_of_the_compute_type(cell, kind):
    reader = core.load_module("metrics", "mfu.backlog")
    config = core.load_json("configs", core.load_json("workloads", cell)["config"])
    assert config["conf"]["dtypes"]["compute"] == kind
    ctx = {"counters": {"frames": 1000, "tokens": 500, "window_s": 2.0},
           "config": config, "device_name": H100}
    conf, m = config["conf"], config["conf"]["model"]
    k = max(config["decoding"]["beam_width"], 1)
    per_eval = FL.predictor_token(m) + FL.joint_single(m)
    if config["decoding"]["use_lm"]:
        per_eval += FL.lm_token(conf["lm"])
    flops = (1000 * (FL.frontend_chunk(conf, 1280) + FL.encoder_frame(m))
             + k * 1500 * per_eval)
    want = 100.0 * flops / 2.0 / FL.PEAKS[H100][kind]
    assert reader.read(ctx) == pytest.approx(want, rel=1e-12)
