"""The port's benchmark harness (libreasr_tpu_torch/bench.py) against the
JAX package's bench.py, on the CPU: the workload it builds and the
emission-rate calibration that pins the flagship proxy's decode load.
The timings themselves run only on the card (chip_smoke.py's bench
phase); here the entry point must raise without one.

Two models: the golden BPE bundle (trained; the calibration's target),
and the tiny random model of tests/test_torch_streaming.py (H 16, V 40)
carried across with `convert.load_jax_variables`, float32. On that model
the emission rate is a step function of the blank bias (10, 7.5, 2.5
and 0 tokens a chunk at 0, 0.5, 1 and 1.5), so both sides' rates and the
bisection's choice are compared exactly: token counts, not timings.
"""

import copy
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from libreasr_tpu_torch import bench as port_bench
from libreasr_tpu_torch.api import ASRBundle
from libreasr_tpu_torch.convert import load_jax_variables
from libreasr_tpu_torch.data.language import get_language
from libreasr_tpu_torch.models.streaming import StreamingEngine
from libreasr_tpu_torch.models.transducer import Transducer, TransducerConfig
from test_torch_streaming import _tiny_conf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAMS = 4


@pytest.fixture(scope="module")
def jax_bench():
    """The JAX package's root bench.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_root_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tiny():
    """(JAX bundle, port bundle) on the same random weights."""
    import jax
    from flax import serialization

    from libreasr_tpu.api import ASRBundle as JaxBundle

    conf = _tiny_conf()
    jb = JaxBundle.from_config(conf)
    np_vars = serialization.to_state_dict(
        jax.tree_util.tree_map(np.asarray, jb.variables))
    model = Transducer(TransducerConfig.from_config(conf))
    load_jax_variables(model, np_vars)
    lang, _ = get_language()
    return jb, ASRBundle(copy.deepcopy(conf), model, lang, torch.device("cpu"))


def _engines(tiny):
    from libreasr_tpu.models.streaming import StreamingEngine as JaxEngine

    jb, pb = tiny
    return JaxEngine(jb, n_streams=STREAMS), StreamingEngine(pb, n_streams=STREAMS)


def _blank_biases(tiny):
    jb, pb = tiny
    return (float(jb.variables["params"]["joint"]["out"]["bias"][0]),
            float(pb.model.joint.out.bias[0]))


@pytest.mark.parametrize("steps", [1, 24])
def test_tone_workload_bit_equal(jax_bench, steps):
    j = jax_bench.tone_workload(5, 2, 1280, steps=steps)
    p = port_bench.tone_workload(5, 2, 1280, steps=steps)
    assert p.dtype == j.dtype == np.float32
    assert p.shape == j.shape
    assert p.tobytes() == j.tobytes()


def test_golden_emission_rate_equals_jax(jax_bench):
    rate = port_bench.golden_emission_rate(device="cpu")
    assert rate == jax_bench.golden_emission_rate()
    assert 0.3 < rate < 0.7  # JAX's documented 0.46 tokens a chunk


def test_latched_and_measured_rates_equal_jax_at_two_biases(jax_bench, tiny):
    jb, pb = tiny
    je, pe = _engines(tiny)
    audio = (np.random.default_rng(3).standard_normal((STREAMS, 10 * 1280))
             * 0.1).astype(np.float32)
    rates = []
    for bias in (0.5, 1.0):
        jax_bench.set_blank_bias(jb, bias, base=0.0)
        port_bench.set_blank_bias(pb, bias, base=0.0)
        j, p = _blank_biases(tiny)
        assert j == p == np.float32(bias)
        measured = port_bench.measure_rate(pe, pb, STREAMS)
        assert measured == jax_bench.measure_rate(je, jb, STREAMS)
        je2, pe2 = _engines(tiny)  # fresh slots for the latched feed
        latched = port_bench.latched_rate(pe2, audio)
        assert latched == jax_bench.latched_rate(je2, audio)
        rates.append((measured, latched))
    # the two biases give two workloads, so the comparison is not vacuous
    assert rates[0][0] > rates[1][0] > 0
    # without `base` both add to the current bias, in float32
    jax_bench.set_blank_bias(jb, 0.25)
    port_bench.set_blank_bias(pb, 0.25)
    j, p = _blank_biases(tiny)
    assert j == p == np.float32(np.float32(1.0) + np.float32(0.25))
    jax_bench.set_blank_bias(jb, 0.0, base=0.0)
    port_bench.set_blank_bias(pb, 0.0, base=0.0)


def test_calibrate_blank_bias_chooses_jax_bias(jax_bench, tiny):
    """The bisection keeps the lowest rate at or above the target, at the
    same bias on both sides (each side's one engine steps through the
    same biases in the same order, so its state history is the same)."""
    jb, pb = tiny
    j_bias, j_rate = jax_bench.calibrate_blank_bias(jb, 2.0, n=STREAMS)
    p_bias, p_rate = port_bench.calibrate_blank_bias(pb, 2.0, n=STREAMS)
    assert (p_bias, p_rate) == (j_bias, j_rate)
    assert p_rate >= 2.0
    # each bundle is left at the chosen bias (its seeded bias is 0, and
    # the test above leaves it there)
    j, p = _blank_biases(tiny)
    assert j == p == np.float32(p_bias)


def test_bench_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_bench.main()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_bench.build_bundle()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_bench.golden_emission_rate()


def test_python_m_bench_raises_naming_cuda():
    out = subprocess.run(
        [sys.executable, "-m", "libreasr_tpu_torch.bench"], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "realtime_streams_per_chip" not in out.stdout


def test_device_timings_need_the_captured_step(tiny):
    """On the CPU the engine has no CUDA graph: the device timings raise
    instead of timing the eager step."""
    _, pb = tiny
    with pytest.raises(RuntimeError, match="CUDA graph"):
        port_bench.device_step_time(pb, 2)
    with pytest.raises(RuntimeError, match="CUDA graph"):
        port_bench.device_resident_rate(pb, 2, steps=2)
    with pytest.raises(RuntimeError, match="CUDA graph"):
        StreamingEngine(pb, n_streams=2).replay_captured(1)


GOLDEN_BPE = os.path.join(ROOT, "tests", "fixtures", "golden", "model_bpe.tar.gz")


@pytest.fixture(scope="module")
def jax_trained_gate(jax_bench, tmp_path_factory):
    """JAX bench.main's gate of a trained bundle, with the golden BPE
    bundle as the trained one: (tone-speech latched rate, floor)."""
    from libreasr_tpu.api import ASRBundle as JaxBundle
    from libreasr_tpu.models.streaming import StreamingEngine as JaxEngine

    spec = importlib.util.spec_from_file_location(
        "jax_make_tone_corpus", os.path.join(ROOT, "scripts", "make_tone_corpus.py"))
    tone = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tone)
    bundle = JaxBundle.from_bundle(
        GOLDEN_BPE, extract_to=str(tmp_path_factory.mktemp("jax_gate")))
    eng = JaxEngine(bundle, n_streams=8)
    chunk = eng.scfg.chunk_samples
    trng = np.random.default_rng(1)
    utts = [tone.render(" ".join(tone.WORDS[int(trng.integers(len(tone.WORDS)))]
                                 for _ in range(6)), trng)
            for _ in range(8)]
    n_chunks = max(len(u) for u in utts) // chunk + 2
    audio = np.zeros((8, n_chunks * chunk), np.float32)
    for i, u in enumerate(utts):
        audio[i, : len(u)] = u
    return jax_bench.latched_rate(eng, audio), 0.5 * jax_bench.golden_emission_rate()


@pytest.mark.parametrize("named", [False, True])
def test_trained_bundle_gate_equals_jax(jax_trained_gate, tmp_path, named):
    """The golden BPE bundle through the trained-bundle gate: the same
    tone-speech rate and floor as JAX's main, so the same decision; a
    bundle named by LIBREASR_BENCH_BUNDLE is used whatever its rate."""
    rate_j, floor_j = jax_trained_gate
    bundle, used, rate, floor = port_bench._trained_bundle(
        GOLDEN_BPE, GOLDEN_BPE if named else None, str(tmp_path), device="cpu")
    assert (rate, floor) == (rate_j, floor_j)
    assert rate > 0  # the tone words make the trained bundle emit
    assert used == (named or rate >= floor)
    assert bundle.device.type == "cpu"


def test_tone_workload_decodes_as_jax_on_the_trained_bundle(tmp_path):
    """The continuous tone speech that main stages for a trained bundle
    (tone_workload's steps > 1, device_resident_rate's input): the same
    tokens from both engines, step by step."""
    from libreasr_tpu.api import ASRBundle as JaxBundle
    from libreasr_tpu.models.streaming import StreamingEngine as JaxEngine

    jb = JaxBundle.from_bundle(GOLDEN_BPE, extract_to=str(tmp_path / "j"))
    pb = ASRBundle.from_bundle(GOLDEN_BPE, extract_to=str(tmp_path / "p"),
                               device="cpu")
    je, pe = JaxEngine(jb, n_streams=STREAMS), StreamingEngine(pb, n_streams=STREAMS)
    wk = port_bench.tone_workload(STREAMS, 1, pe.scfg.chunk_samples, steps=24)
    total = 0
    for step in wk:
        jt, jl = je.step_batch(step)
        pt, pl = pe.step_batch(step)
        np.testing.assert_array_equal(pl, np.asarray(jl))
        for i, n in enumerate(pl):
            np.testing.assert_array_equal(pt[i, :n], np.asarray(jt)[i, :n])
        total += int(pl.sum())
    assert total > 0  # the trained bundle emits on it


def test_trained_bundle_paths(monkeypatch, tmp_path):
    """LIBREASR_BENCH_BUNDLE must exist (main raises before it looks for
    a card); without it the first trained candidate present is benched,
    and none present means the proxy."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("LIBREASR_BENCH_BUNDLE", raising=False)
    assert port_bench._trained_path() == (None, None)
    for cand in port_bench.TRAINED_CANDIDATES[::-1]:
        os.makedirs(os.path.dirname(cand), exist_ok=True)
        open(cand, "wb").close()
        assert port_bench._trained_path() == (cand, None)
    monkeypatch.setenv("LIBREASR_BENCH_BUNDLE", GOLDEN_BPE)
    assert port_bench._trained_path() == (GOLDEN_BPE, GOLDEN_BPE)
    monkeypatch.setenv("LIBREASR_BENCH_BUNDLE", str(tmp_path / "missing.tar.gz"))
    with pytest.raises(FileNotFoundError, match="LIBREASR_BENCH_BUNDLE"):
        port_bench.main()
