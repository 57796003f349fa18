"""The port's telemetry (libreasr_tpu_torch.telemetry): the registry, and
the spans and counters inside the streaming engine and the serving
stepper, on the CPU at a tiny size (a random 1-layer model, 6 slots).

Off, nothing is recorded and neither the clock nor the profiler's range
is touched. On, the engine's counters keep the row rule (valid rows plus
the rows masked by each cause are N x sub-steps, exactly), its sub-step
count is the engine's own, children's totals fit in their parents', and
the outputs are the same as off. Under torch.profiler the program's
spans are profiler ranges, nested. The card's idle gaps need CUDA
events, so here the gap split is held on a registry filled by a fake
clock.
"""

import contextlib
import json
import threading
import time

import numpy as np
import pytest
import torch

from libreasr_tpu_torch import telemetry as tel
from libreasr_tpu_torch.api import ASRBundle
from libreasr_tpu_torch.config import apply_overrides, open_config
from libreasr_tpu_torch.data.language import get_language
from libreasr_tpu_torch.models.streaming import (StreamingConfig,
                                                 StreamingEngine, _leaves)
from libreasr_tpu_torch.models.transducer import Transducer, TransducerConfig
from libreasr_tpu_torch.serving import proto
from libreasr_tpu_torch.serving.server import STAGES, ASRServicer

N = 6
THRESH_MS = 400  # silence reset: 5 steps of 80 ms
DEPTHS = (1, 2, 4, 2, 4, 1, 4, 2)
CAUSES = ("inactive", "empty", "short", "gated")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny products run fastest on one thread, and spare threads only
    contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundle():
    conf = apply_overrides(open_config("config/base.yaml"), ["inference"])
    conf["model"].update(feature_sz=1280, embed_sz=8, hidden_sz=16, out_sz=16,
                         joint_sz=16, vocab_sz=40)
    conf["model"]["encoder"]["num_layers"] = 1
    conf["model"]["predictor"]["num_layers"] = 1
    conf["lm"]["enable"] = False
    conf["dtypes"]["compute"] = "float32"
    torch.manual_seed(0)
    model = Transducer(TransducerConfig.from_config(conf))
    with torch.no_grad():
        # emit: blank less likely, EOS never (its latch would mute a slot)
        model.joint.out.bias[0] -= 2.0
        model.joint.out.bias[2] -= 20.0
    lang, _ = get_language()
    return ASRBundle(conf, model, lang, torch.device("cpu"))


@pytest.fixture(autouse=True)
def registry():
    tel.enable(False)
    tel.reset()
    yield
    tel.enable(False)
    tel.reset()


def _engine(bundle, beam):
    return StreamingEngine(bundle, n_streams=N, scfg=StreamingConfig(
        beam_width=beam, reset_thresh_ms=THRESH_MS))


def _drive(eng, seed=0):
    """Pipelined dispatches of the depths in DEPTHS over 4 of the N slots
    (2 stay closed), each slot given 0 to k + 1 steps of audio in turn
    (empty, short and full backlogs), one slot's silence brought to the
    gate, then a finish / close / open cycle on two slots. Returns every
    collect's packed outputs and the finished slots' text."""
    rng = np.random.default_rng(seed)
    need = eng.samples_per_step
    slots = [eng.open_slot() for _ in range(4)]
    outs, pending = [], None
    for it, k in enumerate(DEPTHS):
        for j, s in enumerate(slots):
            steps = (it + j) % (k + 2)
            if steps:
                eng.append_samples(s, (rng.standard_normal(steps * need)
                                       * 0.1).astype(np.float32))
        if it == 3:
            # one step short of the silence threshold, with steps in flight
            eng.silence_ms[slots[1]] = THRESH_MS - 80
        p = eng.step_dispatch_chained(k) if k > 1 else eng.step_dispatch()
        if pending is not None:
            eng.step_collect(pending)
            outs.append(pending[0].numpy().copy())
        pending = p
    eng.step_collect(pending)
    outs.append(pending[0].numpy().copy())
    texts = []
    for s in slots[:2]:
        eng.append_samples(s, (rng.standard_normal(need // 2) * 0.1
                               ).astype(np.float32))
        texts.append(eng.finish_slot(s))
        eng.close_slot(s)
        eng.open_slot()
    return outs, texts


def _check_rules(eng, steps0):
    snap = tel.snapshot()
    c, spans = snap["counters"], snap["spans"]
    masked = sum(c[f"engine.rows_masked.{w}"] for w in CAUSES)
    assert c["engine.rows"] + masked == N * c["engine.steps"]
    assert c["engine.steps"] == eng.steps - steps0
    assert spans["engine.dispatch"]["count"] == spans["engine.collect"]["count"]
    for w in CAUSES:
        assert c[f"engine.rows_masked.{w}"] > 0, w
    under: dict[str, float] = {}
    for name, sp in spans.items():
        assert sp["self_s"] >= 0 and sp["self_s"] <= sp["total_s"] + 1e-9, name
        for parent, s in sp["parents"].items():
            under[parent] = under.get(parent, 0.0) + s
    for parent, s in under.items():
        assert s <= spans[parent]["total_s"] + 1e-9, parent
    for name in ("engine.dispatch.gather", "engine.dispatch.stage",
                 "engine.dispatch.enqueue"):
        assert spans[name]["parents"].keys() == {"engine.dispatch"}, name
    # the dispatches gather the ring's wire samples: the codec ran at append
    assert "engine.dispatch.encode" not in spans
    for name in ("engine.collect.wait", "engine.collect.distribute"):
        assert spans[name]["parents"].keys() == {"engine.collect"}, name
    for name in ("engine.append", "engine.finish_slot", "engine.flush_slot",
                 "engine.close_slot", "engine.open_slot"):
        assert spans[name]["count"] > 0, name
    return snap


def test_off_records_nothing_and_touches_no_clock_or_profiler(bundle,
                                                              monkeypatch):
    def boom(*a, **k):
        raise AssertionError("called while tracing is off")

    eng = _engine(bundle, 0)
    monkeypatch.setattr(time, "perf_counter_ns", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    assert not tel.on()
    _drive(eng)
    assert tel.snapshot() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("beam", [0, 2])
def test_on_keeps_the_row_rule_and_the_span_tree(bundle, beam):
    eng = _engine(bundle, beam)
    steps0 = eng.steps
    with tel.tracing():
        _drive(eng)
        # a slot that outruns the consumer grows every row's ring
        slot, cap = eng.open_slot(), eng._buf.shape[1]
        grows = tel.snapshot()["counters"].get("engine.ring_grows", 0)
        eng.append_samples(slot, np.zeros(cap + 1, np.float32))
    snap = _check_rules(eng, steps0)
    c = snap["counters"]
    assert c["engine.ring_grows"] == grows + 1 and eng._buf.shape[1] == 2 * cap
    if beam:
        assert snap["spans"]["engine.flush_slot.read"]["count"] > 0
        assert snap["spans"]["engine.flush_slot.read"]["parents"].keys() \
            == {"engine.flush_slot"}
    # nothing moves once tracing is off again
    _drive(_engine(bundle, beam), seed=1)
    assert tel.snapshot()["counters"] == c


@pytest.mark.parametrize("beam", [0, 2])
def test_outputs_equal_with_tracing_on_and_off(bundle, beam):
    runs = []
    for on in (False, True):
        eng = _engine(bundle, beam)
        with tel.tracing() if on else contextlib.nullcontext():
            outs, texts = _drive(eng)
        runs.append((outs, texts, [list(e) for e in eng.emitted],
                     [x.clone() for x in _leaves(eng.state)]))
    (o0, t0, e0, s0), (o1, t1, e1, s1) = runs
    assert len(o0) == len(o1)
    for a, b in zip(o0, o1):
        np.testing.assert_array_equal(a, b)
    assert t0 == t1 and e0 == e1
    for a, b in zip(s0, s1):
        assert torch.equal(a, b)
    if not beam:
        assert sum(int(o[..., -1].sum()) for o in o0) > 0  # tokens compared


def test_profiler_sees_the_programs_spans_nested(bundle):
    eng = _engine(bundle, 0)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        assert tel.on()
        _drive(eng)
    assert not tel.on()
    events = prof.events()
    names = {e.name for e in events}
    for name in ("engine.dispatch", "engine.dispatch.gather",
                 "engine.dispatch.enqueue", "engine.collect",
                 "engine.collect.wait", "engine.append", "engine.finish_slot"):
        assert name in names, name

    def ancestors(e):
        while e.cpu_parent is not None:
            e = e.cpu_parent
            yield e.name

    gathers = [e for e in events if e.name == "engine.dispatch.gather"]
    assert gathers and all("engine.dispatch" in ancestors(e) for e in gathers)
    # and the registry recorded the profiled stretch
    assert tel.snapshot()["spans"]["engine.dispatch"]["count"] >= len(DEPTHS)


def test_export_chrome_writes_json_that_loads(bundle, tmp_path):
    eng = _engine(bundle, 0)
    with tel.tracing():
        _drive(eng)
    path = tmp_path / "trace.json"
    tel.export_chrome(str(path))
    data = json.loads(path.read_text())
    events = data["traceEvents"]
    assert {e["ph"] for e in events} == {"X"}
    assert {"engine.dispatch", "engine.collect"} <= {e["name"] for e in events}
    assert all(e["dur"] >= 0 for e in events)
    assert data["otherData"]["counters"]["engine.steps"] == \
        tel.snapshot()["counters"]["engine.steps"]


def _fake_clock(monkeypatch, ticks):
    it = iter(ticks)
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(it))


def test_gap_split_credits_the_innermost_span(monkeypatch):
    """Spans a [0, 100] holding b [10, 40] and c [50, 60]; a gap of 120 ns
    ending at 100 covers [-20, 100]: 20 outside, a 60, b 30, c 10."""
    _fake_clock(monkeypatch, [0, 10, 40, 50, 60, 100])
    with tel.tracing():
        with tel.span("a"):
            with tel.span("b"):
                pass
            with tel.span("c"):
                pass
        tel.gap(120e-9, 100, threading.get_ident())
    c = tel.snapshot()["counters"]
    got = {k: round(v * 1e9, 6) for k, v in c.items()}
    assert got == {"engine.gap": 120, "engine.gap.outside": 20,
                   "engine.gap.a": 60, "engine.gap.b": 30, "engine.gap.c": 10}
    spans = tel.snapshot()["spans"]
    assert spans["a"]["total_s"] * 1e9 == pytest.approx(100)
    assert spans["a"]["self_s"] * 1e9 == pytest.approx(60)


def test_gap_split_counts_open_spans_and_skips_other_threads(monkeypatch):
    """A gap measured inside a span still open (a finish that collects)
    credits it; another thread's spans and spans closed by `record` are
    not the thread's nesting and take no share."""
    _fake_clock(monkeypatch, [0, 5, 15, 30, 40])
    with tel.tracing():
        with tel.span("outer"):            # 0 .. still open
            with tel.span("inner"):        # 5 .. 15
                pass
            tel.record("waited", 0)        # closed at 30, skipped
            other = threading.Thread(target=tel._REG._add_span, args=(
                "elsewhere", 0, 40, None, None, 0, 40))
            other.start()
            other.join(timeout=10)
            assert not other.is_alive()
            tel.gap(20e-9, 25, threading.get_ident())
    c = tel.snapshot()["counters"]
    got = {k: round(v * 1e9, 6) for k, v in c.items()}
    assert got == {"engine.gap": 20, "engine.gap.outer": 10,
                   "engine.gap.inner": 10}


def test_gaps_record_even_after_tracing_stops(monkeypatch):
    _fake_clock(monkeypatch, [])
    assert not tel.on()
    tel.gap(0.002, 10**9, threading.get_ident())
    c = tel.snapshot()["counters"]
    assert c["engine.gap"] == pytest.approx(0.002)
    assert c["engine.gap.outside"] == pytest.approx(0.002)


def _serve_once(servicer, pcm):
    """One unary call and one stream of pcm through the servicer."""
    servicer.Transcribe(proto.Audio(data=pcm.tobytes(), sr=16000))
    handle = servicer.stepper.open()
    for i in range(0, len(pcm), 1280):
        handle.submit(pcm[i:i + 1280])
    handle.finish()
    deadline = time.monotonic() + 60
    while not handle.poll(0.1)[1]:
        assert time.monotonic() < deadline, "the stream never finished"
    handle.release()


def _check_timings(snap):
    assert set(snap) == set(STAGES)
    for v in snap.values():
        assert set(v) == {"avg_ms", "count"}
        assert v["count"] >= 1 and v["avg_ms"] >= 0


def test_stepper_timings_keep_their_shape(bundle):
    eng = _engine(bundle, 0)
    servicer = ASRServicer(bundle, engine=eng)
    pcm = (np.random.default_rng(3).standard_normal(16000) * 0.1
           ).astype(np.float32)
    try:
        with tel.tracing():
            _serve_once(servicer, pcm)
            snap = servicer.timings.snapshot()
    finally:
        servicer.stepper.shutdown()
    assert not servicer.stepper._thread.is_alive()
    _check_timings(snap)
    spans = tel.snapshot()["spans"]
    assert spans["stepper.queue_wait"]["count"] == -(-len(pcm) // 1280)
    assert spans["stepper.final"]["count"] == 1
    for name in ("stepper.dispatch", "stepper.deliver", "engine.dispatch",
                 "engine.finish_slot"):
        assert spans[name]["count"] >= 1, name


def test_stage_timings_need_no_tracing_and_outlive_a_reset(bundle):
    """The serving stages are timed with tracing off, a `reset()` of the
    registry leaves them, and each servicer counts from its own start."""
    pcm = (np.random.default_rng(4).standard_normal(8000) * 0.1
           ).astype(np.float32)
    snaps = []
    for _ in range(2):
        servicer = ASRServicer(bundle, engine=_engine(bundle, 0))
        try:
            _serve_once(servicer, pcm)
            tel.reset()
            snaps.append(servicer.timings.snapshot())
        finally:
            servicer.stepper.shutdown()
    assert not tel.on()
    assert tel.snapshot() == {"spans": {}, "counters": {}}
    for snap in snaps:
        _check_timings(snap)
        assert snap["preprocess"]["count"] == snap["transcribe"]["count"] == 1
    assert snaps[1]["stream_step"]["count"] <= snaps[0]["stream_step"]["count"] + 2


class _FakeEvent:
    """A CUDA event's timing on a fake clock (ms)."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms

    def synchronize(self):
        pass


def test_mesh_chain_records_one_gap_the_mean_of_its_cards():
    """A mesh engine's chain lands as one `_Joined` of a part a card, each
    timed on its own card: the chain adds one gap, the mean of the cards'
    gaps, ending at the mean of their enqueue times, and only once."""
    from libreasr_tpu_torch.models.streaming import _Joined, _Outputs

    tid = threading.get_ident()
    parts = [_Outputs(torch.full((1, 2, 3), i, dtype=torch.int32),
                      _FakeEvent(0), 7, start=_FakeEvent(start),
                      prev=_FakeEvent(end), t_enq=t_enq, tid=tid)
             for i, (end, start, t_enq) in enumerate(
                 [(10.0, 12.0, 5_000_000), (10.0, 14.0, 5_000_200)])]
    joined = _Joined(parts, 7)
    out = joined.numpy()
    assert out.shape == (1, 4, 3)
    np.testing.assert_array_equal(out[0, :, 0], [0, 0, 1, 1])
    c = tel.snapshot()["counters"]
    assert c["engine.gap"] == pytest.approx(0.003)
    assert c["engine.gap.outside"] == pytest.approx(0.003)
    joined.numpy()
    assert tel.snapshot()["counters"]["engine.gap"] == pytest.approx(0.003)
