"""The port's batched streaming engine (libreasr_tpu_torch.models.
streaming) against the JAX package's, on the CPU, where the port's step
runs eagerly (on the card it is one CUDA graph replay, the `cuda` cases
at the end).

Two models: the golden char bundle (trained; H 96) loaded by both
packages from the same tar.gz, and the tiny random model of
tests/test_streaming.py (H 16, V 40) carried across with
`convert.load_jax_variables`. Random weights emit up to max_iters (10)
tokens a frame, so the decode loop is exercised in full. The JAX
package is imported inside the tests that use it, so that the `cuda`
case runs on a machine without flax.

Tolerances of the state comparison: the two frontends and encoders
compute the same float32 sums in another order (XLA's against
PyTorch's CPU GEMMs). That is a few ulps of the LSTM and predictor
state (values ~1): 1e-5 absolute. The log-mel carry is log(power +
1e-6): where a frame is near silence its power is close to the 1e-6
floor, and the DFT products' absolute error (a few ulps of the frame's
energy) is a larger share of it, so the log moves more (measured 5.5e-5
on one of 5,120 values of the golden clips): 1e-4 absolute. The sample
carry is raw samples, copied: equal. The tokens are compared exactly.
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from helpers.tiny_decoder import assert_state_equal
from libreasr_tpu_torch import telemetry as tel
from libreasr_tpu_torch.api import ASRBundle
from libreasr_tpu_torch.config import apply_overrides, open_config
from libreasr_tpu_torch.convert import load_jax_variables
from libreasr_tpu_torch.data.audio import read_wav
from libreasr_tpu_torch.data.language import get_language
from libreasr_tpu_torch.models.decode import (
    DecoderFns, decode_frame, init_decode_state,
)
from libreasr_tpu_torch.models.streaming import (
    CHAIN_DEPTHS, StreamingConfig, StreamingEngine, _leaves,
)
from libreasr_tpu_torch.models.transducer import Transducer, TransducerConfig
from libreasr_tpu_torch.parallel.mesh import make_mesh
from libreasr_tpu_torch.ops.frontend import features_batch

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
TEXTS = [
    "yes", "no", "hello world", "stop now",
    "go left", "turn right", "one two", "three four",
]
STATE_TOL = 1e-5
SCORE_TOL = 1e-4  # beam scores, as tests/test_beam.py:105
MEL_TOL = 1e-4
CHUNK = 1280


def _tiny_conf():
    conf = apply_overrides(open_config("config/base.yaml"), ["inference"])
    conf["model"].update(feature_sz=1280, embed_sz=8, hidden_sz=16, out_sz=16,
                         joint_sz=16, vocab_sz=40)
    conf["model"]["encoder"]["num_layers"] = 1
    conf["model"]["predictor"]["num_layers"] = 1
    conf["lm"]["enable"] = False
    conf["dtypes"]["compute"] = "float32"
    return conf


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


@pytest.fixture(scope="module")
def golden_audio():
    audio = np.zeros((8, 16000), np.float32)
    for i in range(8):
        pcm, _ = read_wav(os.path.join(FIXTURES, f"s-{i:03d}.wav"))
        audio[i] = pcm[0]
    return audio


def _port_bundle(name, tmp):
    return ASRBundle.from_bundle(os.path.join(FIXTURES, name),
                                 extract_to=str(tmp), device="cpu")


def _noise(seed, shape, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _check_state(jstate, tstate):
    import jax

    np.testing.assert_array_equal(tstate.sample_carry.numpy(),
                                  np.asarray(jstate.sample_carry))
    np.testing.assert_allclose(tstate.mel_carry.numpy(),
                               np.asarray(jstate.mel_carry), rtol=0,
                               atol=MEL_TOL)
    pairs = [("h_pred", jstate.decode.h_pred, tstate.decode.h_pred)]
    pairs += [(f"enc_state[{i}]", a, b) for i, (a, b) in enumerate(zip(
        jax.tree_util.tree_leaves(jstate.enc_state), _leaves(tstate.enc_state)))]
    pairs += [(f"pred_state[{i}]", a, b) for i, (a, b) in enumerate(zip(
        jax.tree_util.tree_leaves(jstate.decode.pred_state),
        _leaves(tstate.decode.pred_state)))]
    for name, a, b in pairs:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=STATE_TOL, err_msg=name)
    for name in ("started", "primed"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                      np.asarray(getattr(jstate, name)))
    np.testing.assert_array_equal(tstate.decode.last_token.numpy(),
                                  np.asarray(jstate.decode.last_token))


@pytest.mark.parametrize("model", ["golden", "tiny"])
def test_engine_matches_jax_step_by_step(model, tiny, golden_audio,
                                         tmp_path):
    """Packed tokens and counts equal at every step, and the stream
    state within STATE_TOL, with ragged valid masks and mid-stream
    resets: 8 slots over the golden clips, 4 over noise on the tiny
    model (max_iters 10)."""
    from libreasr_tpu.api import ASRBundle as JaxBundle
    from libreasr_tpu.models.streaming import StreamingEngine as JaxEngine

    if model == "golden":
        jb = JaxBundle.from_bundle(os.path.join(FIXTURES, "model.tar.gz"),
                                   extract_to=str(tmp_path / "j"))
        tb = _port_bundle("model.tar.gz", tmp_path / "t")
        n, steps = 8, 14
        audio = np.zeros((n, steps * CHUNK), np.float32)
        audio[:, :16000] = golden_audio
    else:
        jb, tb = tiny
        n, steps = 4, 8
        audio = _noise(1, (n, steps * CHUNK))
    je, te = JaxEngine(jb, n_streams=n), StreamingEngine(tb, n_streams=n)
    rng = np.random.default_rng(2)
    emitted = 0
    for k in range(steps):
        chunks = audio[:, None, k * CHUNK : (k + 1) * CHUNK]
        valid = rng.random(n) > 0.15
        reset = (rng.random(n) > 0.85) if k > 2 else np.zeros(n, bool)
        jt, jl = je.step_batch(chunks, valid, reset)
        tt, tl = te.step_batch(chunks, valid, reset)
        np.testing.assert_array_equal(tl, jl, err_msg=f"step {k}")
        np.testing.assert_array_equal(tt, jt, err_msg=f"step {k}")
        _check_state(je.state, te.state)
        emitted += int(tl.sum())
    assert emitted > 0


def test_stream_features_equal_batch_features(tiny):
    """The incremental frontend, from a reset carry, gives the stacked
    frames features_batch computes over the whole signal (the first,
    warmup, frame skipped)."""
    _, tb = tiny
    eng = StreamingEngine(tb, n_streams=2)
    n_chunks = 8
    audio = _noise(3, (2, n_chunks * CHUNK))
    x = torch.from_numpy(audio)
    sc = x[:, 1 : eng._sample_carry_len + 1].flip(1)
    mc = torch.zeros_like(eng.state.mel_carry)
    frames = []
    for k in range(n_chunks):
        stacked, sc, mc = eng.frontend_step(sc, mc, x[:, k * CHUNK : (k + 1) * CHUNK])
        frames.append(stacked)
    got = torch.cat(frames[1:], dim=1)
    want, flens = features_batch(x, torch.tensor([x.shape[1]] * 2), tb.frontend)
    assert int(flens[0]) == n_chunks - 1 == got.shape[1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=MEL_TOL)


def _feed_golden(bundle, audio):
    eng = StreamingEngine(bundle, n_streams=8)
    slots = [eng.open_slot() for _ in range(8)]
    for off in range(0, 16000, CHUNK):
        for i, s in enumerate(slots):
            eng.feed(s, audio[i, off : off + CHUNK])
    # flush the tail the exact frontend is still carrying (~40 ms)
    for s in slots:
        eng.feed(s, np.zeros(CHUNK, np.float32))
    return [eng.transcript(s) for s in slots]


@pytest.mark.parametrize("kind", ["char", "int8", "bpe"])
def test_golden_clips_exact_through_feed(kind, golden_audio, tmp_path):
    """char; char quantized by the port, saved and reloaded; BPE."""
    if kind == "int8":
        q = _port_bundle("model.tar.gz", tmp_path / "src").quantize()
        bundle = _port_bundle(q.save(str(tmp_path / "int8.tar.gz")), tmp_path / "re")
        assert bundle.cfg.quantized_cells
    else:
        bundle = _port_bundle("model_bpe.tar.gz" if kind == "bpe"
                              else "model.tar.gz", tmp_path)
    assert _feed_golden(bundle, golden_audio) == TEXTS


def test_transcribe_stream_generator(golden_audio, tmp_path):
    """The generator API yields growing transcripts; its engine is
    cached per config, and quantize() drops it."""
    bundle = _port_bundle("model.tar.gz", tmp_path)
    chunks = [golden_audio[2, i : i + CHUNK] for i in range(0, 16000, CHUNK)]
    chunks.append(np.zeros(CHUNK, np.float32))  # flush the frontend carry
    for _ in range(2):
        last, texts = "", []
        for y_all, new_text, reset_fn in bundle.transcribe_stream(chunks):
            last = bundle.lang.denumericalize(y_all)
            texts.append(new_text)
        assert last == "hello world" == "".join(texts)
        assert callable(reset_fn)
    assert len(bundle._stream_engines) == 1
    bundle.quantize()
    assert not bundle._stream_engines


def test_engine_refuses_a_swapped_model(tmp_path):
    """A graph holds the addresses of the weights it was captured with:
    an engine whose bundle was quantized after it was built raises
    rather than serve the old weights."""
    bundle = _port_bundle("model.tar.gz", tmp_path)
    eng = StreamingEngine(bundle, n_streams=1)
    bundle.quantize()
    with pytest.raises(RuntimeError, match="model changed"):
        eng.step_batch(np.zeros((1, 1, CHUNK), np.float32))


def test_streaming_equals_batch_decode(tiny):
    """The chunked decode equals features_batch -> encode -> greedy over
    the same audio (tests/test_streaming.py:27)."""
    from libreasr_tpu_torch.models.decode import greedy_decode

    _, tb = tiny
    n_chunks = 8
    audio = _noise(4, n_chunks * CHUNK)
    eng = StreamingEngine(tb, n_streams=1)
    got = []
    for k in range(n_chunks):
        toks, lens = eng.step_batch(audio[k * CHUNK : (k + 1) * CHUNK][None, None])
        got.extend(toks[0, : lens[0]])
    with torch.inference_mode():
        feats, flens = features_batch(torch.from_numpy(audio)[None],
                                      torch.tensor([len(audio)]), tb.frontend)
        enc_out, _ = tb.model.encode(feats, lengths=flens)
        toks, lens, _, _ = greedy_decode(
            tb.decoder_fns(use_lm=False), enc_out, flens, blank=tb.cfg.blank,
            bos=tb.cfg.bos, max_iters=eng.scfg.max_iters,
            max_tokens=eng.scfg.max_iters * n_chunks + 8)
    assert got == toks[0, : int(lens[0])].tolist()
    assert got


def test_n_buffer_two_equals_one(tiny):
    _, tb = tiny
    audio = _noise(5, (2, CHUNK))
    e1 = StreamingEngine(tb, n_streams=1)
    single = []
    for k in range(2):
        t, l = e1.step_batch(audio[k][None, None])
        single += list(t[0, : l[0]])
    e2 = StreamingEngine(tb, n_streams=1, scfg=StreamingConfig(n_buffer=2))
    t2, l2 = e2.step_batch(audio[None])
    assert list(t2[0, : l2[0]]) == single


def test_slots_are_independent(tiny):
    _, tb = tiny
    eng = StreamingEngine(tb, n_streams=4)
    s1, s2, s3 = eng.open_slot(), eng.open_slot(), eng.open_slot()
    audio = _noise(6, CHUNK * 10)
    other = _noise(7, CHUNK * 10, 0.3)
    for i in range(0, len(audio), CHUNK):
        eng.feed(s3, other[i : i + CHUNK])
        eng.feed(s1, audio[i : i + CHUNK])
        eng.feed(s2, audio[i : i + CHUNK])
    assert eng.transcript(s1) == eng.transcript(s2) != ""


def test_reset_restores_fresh_state(tiny):
    _, tb = tiny
    w1, w2 = _noise(8, (2, 1, CHUNK), 1.0), _noise(9, (2, 1, CHUNK), 1.0)
    eng = StreamingEngine(tb, n_streams=2)
    eng.step_batch(w1)
    toks_a, lens_a = eng.step_batch(w2, reset=np.array([True, False]))
    toks_b, lens_b = StreamingEngine(tb, n_streams=2).step_batch(w2)
    np.testing.assert_array_equal(toks_a[0, : lens_a[0]], toks_b[0, : lens_b[0]])


def test_engine_refuses_deltas_and_mesh_and_takes_beam_lm(tiny):
    """The engine refuses delta features (offline decoding takes them;
    the delta filter reads future frames, as JAX's engine says) and a
    mesh whose data axis does not divide the streams (JAX's assert); it
    takes beam search and LM fusion: a beam engine is built, and a bundle
    without an LM decodes without, as in JAX."""
    _, tb = tiny
    with_deltas = copy.copy(tb)
    with_deltas.frontend = dataclasses.replace(tb.frontend, deltas=1)
    with pytest.raises(NotImplementedError, match="deltas"):
        StreamingEngine(with_deltas, n_streams=1)
    with pytest.raises(AssertionError, match="n_streams must divide"):
        StreamingEngine(tb, n_streams=6, mesh=make_mesh(data=4, devices=["cpu"] * 4))
    eng = StreamingEngine(tb, n_streams=1, scfg=StreamingConfig(beam_width=4),
                          use_lm=True)
    assert eng.beam and eng.fns.lm_step is None
    assert eng._packed.shape == (1, eng.scfg.beam_buf_tokens + 1)
    assert next(tb.transcribe_stream([np.zeros(CHUNK, np.float32)],
                                     use_lm=True))[1] == ""


def _mesh_vs_single(tb, scfg, steps, seed):
    """tests/test_streaming.py:136 and :154 through the port: 8 streams on
    a data-8 mesh of CPU devices (one sub-engine, with its own weights,
    a stream) against the single engine, step by step."""
    mesh = make_mesh(data=8, model=1, devices=["cpu"] * 8)
    e1 = StreamingEngine(tb, n_streams=8, scfg=scfg)
    e2 = StreamingEngine(tb, n_streams=8, scfg=scfg, mesh=mesh)
    assert len(e2._shards) == 8
    assert all(sh.model is not tb.model for sh in e2._shards)
    emitted = 0
    for k in range(steps):
        chunks = _noise(seed + k, (8, 1, CHUNK))
        t1, l1 = e1.step_batch(chunks)
        t2, l2 = e2.step_batch(chunks)
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(t1, t2)
        emitted += int(l1.sum())
    assert e2.steps == steps
    return emitted


def test_engine_on_mesh_matches_single(tiny_emitting):
    _, tb = tiny_emitting
    assert _mesh_vs_single(tb, None, 3, 30) > 0


def test_beam_engine_on_mesh_matches_single(tiny_emitting):
    _, tb = tiny_emitting
    scfg = StreamingConfig(beam_width=2, max_iters=3, beam_buf_tokens=8)
    assert _mesh_vs_single(tb, scfg, 4, 40) > 0


def test_mesh_engine_enqueues_each_shard_on_its_own_device(tiny_emitting,
                                                          monkeypatch):
    """A mesh engine's sub-engine builds its state (and, on the card, its
    graph) and runs its steps while its own device is current, so that
    the streams, events and graph capture of that work belong to the
    card holding its tensors (streaming._on_device, watched here)."""
    import contextlib

    from libreasr_tpu_torch.models import streaming

    current = []

    @contextlib.contextmanager
    def on_device(device):
        current.append(device)
        try:
            yield
        finally:
            current.pop()

    seen = []

    def watch(fn):
        def run(self):
            seen.append((fn.__name__, current[-1] if current else None,
                         self.device))
            return fn(self)
        return run

    monkeypatch.setattr(streaming, "_on_device", on_device)
    monkeypatch.setattr(StreamingEngine, "_init_device",
                        watch(StreamingEngine._init_device))
    monkeypatch.setattr(StreamingEngine, "_step_in_place",
                        watch(StreamingEngine._step_in_place))
    _, tb = tiny_emitting
    eng = StreamingEngine(tb, n_streams=4,
                          mesh=make_mesh(data=2, devices=["cpu"] * 2))
    eng.step_batch(_noise(5, (4, 1, CHUNK)))
    assert [name for name, _, _ in seen] == ["_init_device"] * 2 + [
        "_step_in_place"] * 2
    assert all(cur is not None and cur == dev for _, cur, dev in seen)


def test_chained_dispatch_matches_sequential(tiny):
    """k sub-steps in one dispatch emit what k sequential steps emit,
    with a slot of a shorter backlog riding along."""
    _, tb = tiny
    audio_a, audio_b = _noise(10, CHUNK * 8), _noise(11, CHUNK * 3, 0.2)

    def run(chained: bool):
        eng = StreamingEngine(tb, n_streams=2)
        sa, sb = eng.open_slot(), eng.open_slot()
        eng.append_samples(sa, audio_a)  # backlog depth 8
        eng.append_samples(sb, audio_b)  # backlog depth 3
        if chained:
            for _ in range(2):
                eng.step_collect(eng.step_dispatch_chained(4))
        else:
            while (p := eng.step_dispatch()) is not None:
                eng.step_collect(p)
        return (eng.drain(sa), eng.drain(sb), list(eng.emitted[sa]),
                list(eng.emitted[sb]), eng.steps)

    seq, cha = run(False), run(True)
    assert cha[:4] == seq[:4]
    assert seq[2]
    assert (seq[4], cha[4]) == (8, 8)  # sub-steps run, either way


def test_chained_dispatch_reset_semantics(tiny):
    """Pending resets apply at a chain's first sub-step; a chain after
    close/reopen decodes from scratch."""
    _, tb = tiny
    audio = _noise(12, CHUNK * 4)
    eng = StreamingEngine(tb, n_streams=1)
    s = eng.open_slot()
    eng.append_samples(s, audio)
    eng.step_collect(eng.step_dispatch_chained(4))
    first = list(eng.emitted[s])
    eng.close_slot(s)
    assert eng.open_slot() == s
    eng.append_samples(s, audio)
    eng.step_collect(eng.step_dispatch_chained(4))
    assert list(eng.emitted[s]) == first


def _silence_capped(tb, chained):
    scfg = StreamingConfig(reset_thresh_ms=160)
    eng = StreamingEngine(tb, n_streams=1, scfg=scfg)
    s = eng.open_slot()
    eng.append_samples(s, _noise(13, CHUNK * 6))
    eng.silence_ms[s] = scfg.reset_thresh_ms - scfg.chunk_ms
    caps = []
    if chained:
        while (p := eng.step_dispatch_chained(4)) is not None:
            caps.append(int(np.asarray(p[1], bool).sum()))
            eng.step_collect(p)
    else:
        while (p := eng.step_dispatch()) is not None:
            eng.step_collect(p)
    return list(eng.emitted[s]), eng.drain(s), caps


def test_chained_dispatch_caps_at_silence_threshold(tiny):
    """With silence one step short of the threshold, a k=4 chain takes
    exactly one sub-step, and the chained run equals the sequential."""
    _, tb = tiny
    seq_em, seq_txt, _ = _silence_capped(tb, False)
    cha_em, cha_txt, caps = _silence_capped(tb, True)
    assert (cha_em, cha_txt) == (seq_em, seq_txt)
    assert caps[0] == 1 and seq_em


def test_pipelined_dispatch_gates_on_inflight_silence(tiny):
    _, tb = tiny
    scfg = StreamingConfig(reset_thresh_ms=160)
    eng = StreamingEngine(tb, n_streams=1, scfg=scfg)
    s = eng.open_slot()
    eng.append_samples(s, _noise(14, CHUNK * 6))
    p1 = eng.step_dispatch()
    assert p1 is not None and int(eng._inflight[s]) == 1
    eng.silence_ms[s] = scfg.reset_thresh_ms - scfg.chunk_ms
    assert eng._silence_gated(s)
    assert eng.step_dispatch() is None
    assert eng.step_dispatch_chained(4) is None
    eng.step_collect(p1)
    assert int(eng._inflight[s]) == 0
    p2 = eng.step_dispatch_chained(4)
    assert p2 is not None
    eng.step_collect(p2)


def test_collect_after_reopen_keeps_new_occupants_inflight(tiny):
    _, tb = tiny
    audio = _noise(15, CHUNK * 6)
    eng = StreamingEngine(tb, n_streams=1)
    s = eng.open_slot()
    eng.append_samples(s, audio)
    p_old = eng.step_dispatch()
    eng.close_slot(s)
    assert eng.open_slot() == s and int(eng._inflight[s]) == 0
    eng.append_samples(s, audio)
    p_new = eng.step_dispatch()
    assert int(eng._inflight[s]) == 1
    eng.step_collect(p_old)  # stale: the epoch moved past its dispatch
    assert int(eng._inflight[s]) == 1
    eng.step_collect(p_new)
    assert int(eng._inflight[s]) == 0


def test_pipelined_run_matches_sequential(tiny):
    """Dispatch-ahead driving (as the serving stepper does, chained and
    single steps mixed) emits what sequential dispatch/collect emits,
    with a tight silence threshold in play."""
    _, tb = tiny
    audio = _noise(16, CHUNK * 10)
    scfg = StreamingConfig(reset_thresh_ms=160)

    def run(pipelined: bool):
        eng = StreamingEngine(tb, n_streams=1, scfg=scfg)
        s = eng.open_slot()
        eng.append_samples(s, audio)
        eng.silence_ms[s] = scfg.reset_thresh_ms - scfg.chunk_ms
        if pipelined:
            pending = None
            while True:
                p = (eng.step_dispatch_chained(4) if eng.backlog_depth() >= 2
                     else eng.step_dispatch())
                if p is None:
                    if pending is not None:
                        eng.step_collect(pending)
                        pending = None
                        continue  # a landed collect can un-gate the slot
                    break
                if pending is not None:
                    eng.step_collect(pending)
                pending = p
        else:
            while (p := eng.step_dispatch()) is not None:
                eng.step_collect(p)
        return list(eng.emitted[s]), eng.drain(s)

    assert run(True) == run(False)


def test_warmup_runs_chains_without_touching_slots(tiny):
    _, tb = tiny
    eng = StreamingEngine(tb, n_streams=2)
    eng.warmup(1, chain_depths=CHAIN_DEPTHS)
    assert eng.steps == 1 + sum(CHAIN_DEPTHS)
    assert all(not o for o in eng.outbox) and int(eng._inflight.sum()) == 0


def test_int16_transfer_matches_float32(tiny):
    """16-bit-sourced audio is exact in the int16 codec, so both decode
    alike."""
    _, tb = tiny
    audio = (np.random.default_rng(17).standard_normal((2, 4, CHUNK)) * 3000
             ).astype(np.int16).astype(np.float32) / 32768.0
    out = {}
    for dtype in ("int16", "float32"):
        eng = StreamingEngine(tb, n_streams=2,
                              scfg=StreamingConfig(transfer_dtype=dtype))
        assert eng._chunks.dtype == getattr(torch, dtype)
        got = [[], []]
        for c in range(audio.shape[1]):
            toks, lens = eng.step_batch(audio[:, c][:, None])
            for i in range(2):
                got[i] += toks[i, : lens[i]].tolist()
        out[dtype] = got
    assert out["int16"] == out["float32"] and out["int16"][0]



# ---- input staging: the wire codec at append, pooled staging buffers -------


def _bf16_bundle(seed=0):
    """The tiny model computing in bf16 (random weights, no JAX)."""
    conf = _tiny_conf()
    conf["dtypes"]["compute"] = "bfloat16"
    model = Transducer(TransducerConfig.from_config(conf), seed=seed)
    lang, _ = get_language()
    return ASRBundle(conf, model, lang, torch.device("cpu"))


def _staged(eng):
    """Record the wire array every chain of `eng` enqueues."""
    seen = []
    launch = eng._launch

    def spy(k, st, valid, reset, masked=None):
        seen.append((st.wire[:k].copy(), np.array(valid, bool)))
        return launch(k, st, valid, reset, masked)

    eng._launch = spy
    return seen


@pytest.mark.parametrize("n_buffer", [1, 2])
@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_staged_wire_equals_encode_of_float32_gather(tiny, dtype, n_buffer):
    """Every chain's staged wire array, from step_dispatch and from
    step_dispatch_chained, pipelined so that the pooled buffers are
    reused, equals bit for bit `_encode_chunks` of the float32 gather of
    the same appended PCM (masked rows zero), across ring compactions and
    a ring growth; the ring holds the wire dtype."""
    _, tb = tiny
    n = 3
    eng = StreamingEngine(tb, n_streams=n, scfg=StreamingConfig(
        n_buffer=n_buffer, transfer_dtype=dtype))
    assert eng._buf.dtype == np.dtype(dtype)
    assert all(st.wire.dtype == np.dtype(dtype) for st in eng._stages)
    need = eng.samples_per_step
    cap0 = eng._buf.shape[1]
    seen = _staged(eng)
    rng = np.random.default_rng(21)
    queue = [np.zeros(0, np.float32) for _ in range(n)]
    slots = [eng.open_slot(), eng.open_slot()]  # slot 2 stays closed
    expect, pending, compacted = [], None, 0
    # sizes in steps (and odd samples): clipping, truncation toward zero,
    # compactions, and one append past the ring's capacity (growth)
    plan = [(3, 1.5), (1.3, 0.7), (2, 1.2), (0, 0), (2.6, 0.9), (1, 2.0),
            (6.5, 0.8), (0.5, 0.3), (2, 1.0), (0, 0), (1.7, 1.1), (3, 0.6)]
    for it, (steps, scale) in enumerate(plan):
        for j, s in enumerate(slots):
            m = int(steps * need) + (17 if j else 0)
            if not m or (it + j) % 3 == 2:
                continue
            pcm = (rng.standard_normal(m) * scale).astype(np.float32)
            heads = int(eng._head[s])
            eng.append_samples(s, pcm)
            compacted += heads > 0 and int(eng._head[s]) == 0
            queue[s] = np.concatenate([queue[s], pcm])
        k = (1, 4, 2, 8)[it % 4]
        p = eng.step_dispatch_chained(k) if k > 1 else eng.step_dispatch()
        if p is not None:
            valid = seen[-1][1]
            chunks = np.zeros((valid.shape[0], n, need), np.float32)
            for j in range(valid.shape[0]):
                for i in np.nonzero(valid[j])[0]:
                    chunks[j, i], queue[i] = queue[i][:need], queue[i][need:]
            expect.append(eng._encode_chunks(
                chunks.reshape(len(valid), n, n_buffer, -1)))
        if pending is not None:
            eng.step_collect(pending)
        pending = p
    eng.step_collect(pending)
    assert eng._buf.shape[1] > cap0 and compacted
    assert len(seen) == len(expect) >= 10
    for (got, _), want in zip(seen, expect):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_chains_in_flight_hold_distinct_staging_buffers(tiny):
    """Two chains in flight hold the pool's two buffers; a third, with
    both still unread, gets a fresh one (counted); once read, the
    buffers serve the next chains again."""
    _, tb = tiny
    eng = StreamingEngine(tb, n_streams=2)
    s = eng.open_slot()
    eng.append_samples(s, _noise(22, CHUNK * 12))
    pool = list(eng._stages)
    with tel.tracing():
        tel.reset()
        p1 = eng.step_dispatch_chained(2)
        p2 = eng.step_dispatch()
        users = [st.user() for st in pool]
        assert {id(u) for u in users} == {id(p1[0]), id(p2[0])}
        assert "engine.stage.fresh" not in tel.snapshot()["counters"]
        p3 = eng.step_dispatch_chained(4)
        assert tel.snapshot()["counters"]["engine.stage.fresh"] == 1
        assert len(eng._stages) == 3 and eng._stages[2].user() is p3[0]
        for p in (p1, p2, p3):
            eng.step_collect(p)
        p4 = eng.step_dispatch()
        assert any(st.user() is p4[0] for st in pool)
        eng.step_collect(p4)
        assert tel.snapshot()["counters"]["engine.stage.fresh"] == 1
    tel.reset()


def test_stage_fresh_stays_zero_in_a_steady_loop(tiny):
    """After warm-up a pipelined loop (one chain in flight while the
    next is gathered, chained and single steps) allocates no staging."""
    _, tb = tiny
    eng = StreamingEngine(tb, n_streams=3)
    eng.warmup(1, chain_depths=CHAIN_DEPTHS)
    slots = [eng.open_slot() for _ in range(3)]
    rng = np.random.default_rng(23)
    with tel.tracing():
        tel.reset()
        pending = None
        for it in range(16):
            for j, s in enumerate(slots):
                if (it + j) % 2 == 0:
                    eng.append_samples(s, (rng.standard_normal(
                        CHUNK * (1 + (it + j) % 5)) * 0.1).astype(np.float32))
            depth = eng.backlog_depth()
            p = (eng.step_dispatch_chained(min(8, 1 << (depth.bit_length() - 1)))
                 if depth >= 2 else eng.step_dispatch())
            if pending is not None:
                eng.step_collect(pending)
            pending = p
        eng.step_collect(pending)
        c = tel.snapshot()["counters"]
    tel.reset()
    assert c["engine.steps"] > 16
    assert c.get("engine.stage.fresh", 0) == 0 and len(eng._stages) == 2


def test_engine_casts_tower_matrices_once(tiny):
    """A bf16 model's engine steps a copy whose cell kernels, recurrent
    kernels and joint kernels are bf16, cast at build; every other
    tensor, the biases included, is the bundle's own, and the bundle's
    model keeps float32. A float32 (beam) engine casts nothing."""
    bundle = _bf16_bundle()
    eng = StreamingEngine(bundle, n_streams=2)
    # encoder 1 layer, predictor 1 layer: 2 matrices each; joint 3
    assert eng.tensor_core_weights == 7
    net, model = eng._net, bundle.model
    assert net is not model
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for cell in (net.encoder.rnn_stack.layer0.cell,
                 net.predictor.rnn_stack.layer0.cell):
        assert cell.kernel.dtype == cell.recurrent_kernel.dtype == torch.bfloat16
    for d in (net.joint.pred_proj, net.joint.enc_proj, net.joint.out):
        assert d.kernel.dtype == torch.bfloat16
    assert net.joint.out.bias is model.joint.out.bias
    assert net.encoder.rnn_stack.layer0.cell.bias is \
        model.encoder.rnn_stack.layer0.cell.bias
    assert net.predictor.embed.embedding is model.predictor.embed.embedding
    assert eng.fns.joint_step.__self__ is net
    _, tb = tiny
    beam = StreamingEngine(tb, n_streams=2, scfg=StreamingConfig(beam_width=4))
    assert beam.tensor_core_weights == 0 and beam._net is tb.model


def test_bf16_engine_sees_a_blank_bias_set_after_build():
    """The bias calibration (bench.set_blank_bias) moves the joint's blank
    bias in place under a built engine: a bf16 engine steps the model's
    own bias, so its emission follows without a new build."""
    from libreasr_tpu_torch import bench

    bundle = _bf16_bundle(seed=5)
    eng = StreamingEngine(bundle, n_streams=4)
    base = bundle.model.joint.out.bias[0].clone()
    chunks = _noise(77, (4, 1, CHUNK), 0.3)

    def tokens(bias):
        bench.set_blank_bias(bundle, bias, base=base)
        first = np.ones(4, bool)
        return sum(int(eng.step_batch(chunks, reset=first if j == 0 else None)
                       [1].sum()) for j in range(4))

    flood, mute, again = tokens(-30.0), tokens(30.0), tokens(-30.0)
    assert mute == 0 < flood == again


def test_bf16_engine_equals_the_uncast_step_on_cpu(monkeypatch):
    """On the CPU a product of a weight held in bf16 is the rounded
    float32 product, so the engine's tokens and state equal those of
    the step that rounds its float32 weights every call, exactly."""
    import libreasr_tpu_torch.models.streaming as streaming

    bundle = _bf16_bundle(seed=3)
    cast = StreamingEngine(bundle, n_streams=3)
    monkeypatch.setattr(streaming, "_tensor_core_copy", lambda m: (m, 0))
    plain = StreamingEngine(bundle, n_streams=3)
    assert cast.tensor_core_weights == 7 and plain._net is bundle.model
    rng = np.random.default_rng(24)
    total = 0
    for k in range(6):
        chunks = _noise(300 + k, (3, 1, CHUNK), 0.3)
        valid, reset = rng.random(3) > 0.2, rng.random(3) > 0.8
        t1, l1 = cast.step_batch(chunks, valid, reset)
        t2, l2 = plain.step_batch(chunks, valid, reset)
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(t1, t2)
        total += int(l1.sum())
    for a, b in zip(_leaves(cast.state), _leaves(plain.state)):
        assert torch.equal(a, b)
    assert total > 0


@pytest.mark.parametrize("seed", range(20))
def test_decode_frame_without_early_exit_is_identical(tiny, seed):
    """All max_iters rounds masked give the same tokens, counts and
    state as stopping once no stream is active. The blank logit is
    biased per seed so that streams stop after 0 to max_iters rounds."""
    _, tb = tiny
    model = copy.deepcopy(tb.model)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        model.joint.out.bias[0] += float(rng.uniform(-2.0, 6.0))
    fns = DecoderFns(predict_step=model.predict, joint_step=model.joint_step)
    n, max_iters = 6, int(rng.integers(1, 11))
    with torch.no_grad():
        st = init_decode_state(fns, n, bos=2, max_tokens=12)
        outs = {True: st, False: st}
        for _ in range(3):
            h_enc = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
            valid = torch.from_numpy(rng.random(n) > 0.2)
            for early in (True, False):
                outs[early] = decode_frame(fns, outs[early], h_enc, valid,
                                           max_iters=max_iters,
                                           early_exit=early)
    for a, b in zip(_leaves(outs[True]), _leaves(outs[False])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["model.tar.gz", "model_bpe.tar.gz"])
def test_eos_latch_matches_jax(name, tmp_path):
    """The same packed outputs with an EOS through both engines'
    _distribute leave the same emitted / outbox / _eos_done / silence
    and pending resets: the char EOS is 2, the BPE EOS 3."""
    from libreasr_tpu.api import ASRBundle as JaxBundle
    from libreasr_tpu.models.streaming import StreamingConfig as JaxConfig
    from libreasr_tpu.models.streaming import StreamingEngine as JaxEngine

    jb = JaxBundle.from_bundle(os.path.join(FIXTURES, name),
                               extract_to=str(tmp_path / "j"))
    tb = _port_bundle(name, tmp_path / "t")
    assert tb.lang.eos == jb.lang.eos == (3 if "bpe" in name else 2)
    scfg = dict(reset_thresh_ms=160)
    je = JaxEngine(jb, n_streams=4, scfg=JaxConfig(**scfg))
    te = StreamingEngine(tb, n_streams=4, scfg=StreamingConfig(**scfg))
    eos, k = tb.lang.eos, te.scfg.max_tokens_per_step
    rows = [
        [[5, 6, eos, 7], [8], [9, 10], []],   # slot 0 latches mid-list
        [[11], [eos], [12, 13], [14]],        # slot 1 latches alone
        [[], [], [], [15]],                   # slot 2: silence -> reset
        [[16, 17], [18, eos, eos], [], [19]],
    ]
    for e in (je, te):
        for s in range(4):
            e.open_slot()
    for step in range(4):
        packed = np.zeros((4, k + 1), np.int32)
        for i in range(4):
            ids = rows[i][step]
            packed[i, : len(ids)] = ids
            packed[i, -1] = len(ids)
        valid = np.ones(4, bool)
        for e in (je, te):
            e._distribute(packed, valid, e._reset_epoch.copy())
        assert te.emitted == je.emitted
        assert te.outbox == je.outbox
        for attr in ("_eos_done", "silence_ms", "_pending_reset_arr"):
            np.testing.assert_array_equal(getattr(te, attr), getattr(je, attr))
    assert te._eos_done[:2].all() and te._pending_reset_arr[2]


@pytest.fixture(scope="module")
def tiny_emitting(tiny):
    """The tiny model with its blank logit lowered by 6 on both sides:
    with the blank as likely as the random weights make it, every
    hypothesis that emits pays for it and the beam keeps the all-blank
    one (no token in 8 steps); lowered, beams emit and disagree, and the
    8-token buffer below saturates (the forced commit)."""
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from libreasr_tpu.api import ASRBundle as JaxBundle

    jb, tb = tiny
    variables = serialization.to_state_dict(
        jax.tree_util.tree_map(lambda x: np.array(x), jb.variables))
    variables["params"]["joint"]["out"]["bias"][0] -= 6.0
    jb2 = JaxBundle(jb.conf, jb.model, jax.tree_util.tree_map(
        jnp.asarray, serialization.from_state_dict(jb.variables, variables)),
        jb.lang)
    model = Transducer(tb.cfg)
    load_jax_variables(model, variables)
    return jb2, ASRBundle(copy.deepcopy(tb.conf), model, tb.lang, torch.device("cpu"))


def test_streaming_beam_commits_match_batch_beam(tiny_emitting):
    """tests/test_streaming.py:101 through the port: the committed tokens
    of a beam engine plus the flush at close equal beam_decode over the
    same features (K 3, 3 rounds a frame)."""
    from libreasr_tpu_torch.models.beam import beam_decode

    _, tb = tiny_emitting
    audio = _noise(18, 6 * CHUNK)
    eng = StreamingEngine(tb, n_streams=1, scfg=StreamingConfig(
        beam_width=3, max_iters=3, beam_buf_tokens=64))
    s = eng.open_slot()
    eng.feed(s, audio)
    eng.close_slot(s)  # flushes the uncommitted tail
    with torch.inference_mode():
        feats, flens = features_batch(torch.from_numpy(audio)[None],
                                      torch.tensor([len(audio)]), tb.frontend)
        enc_out, _ = tb.model.encode(feats, lengths=flens)
        toks, lens, _ = beam_decode(tb.decoder_fns(use_lm=False), enc_out, flens,
                                    vocab_sz=tb.cfg.vocab_sz, beam_width=3,
                                    max_expand=3, max_tokens=64)
    assert eng.emitted[s] == toks[0, : int(lens[0])].tolist()
    assert eng.emitted[s]


BEAM_FIELDS = ("pred_state", "h_pred", "last_token", "scores", "y_buf", "y_len",
               "lm_state", "lm_logp")
GREEDY_LM_FIELDS = ("pred_state", "h_pred", "last_token", "lm_state",
                    "lm_logits", "lm_primed")


@pytest.mark.parametrize("model", ["bpe_beam_lm", "tiny_beam", "bpe_greedy_lm"])
def test_beam_and_lm_engines_match_jax_step_by_step(model, tiny_emitting,
                                                    golden_audio, tmp_path,
                                                    monkeypatch):
    """Packed tokens and counts equal at every step, and the decode state
    (every BeamState leaf, or the greedy state with the LM's) within
    STATE_TOL (measured 3.8e-6 at most, in the LM's carry), the beam
    scores within SCORE_TOL (sums of up to 140 rounds' log-probs,
    measured 5.7e-6), with ragged valid masks and mid-stream resets; then
    every slot's beam tail flushed on both sides, emitted and outbox
    equal:
    - the BPE golden bundle with its LM, K 3, alpha 0.2 (the wire
      fixture of tests/test_serving.py:318; its beams keep an all-blank
      hypothesis alive, so little commits before the flush);
    - the tiny random model (blank lowered), K 3, 3 rounds and an 8-token
      buffer, so that the forced commit fires (counted);
    - the BPE golden bundle greedy with LM fusion."""
    from libreasr_tpu.api import ASRBundle as JaxBundle
    from libreasr_tpu.models.streaming import StreamingConfig as JaxConfig
    from libreasr_tpu.models.streaming import StreamingEngine as JaxEngine
    from libreasr_tpu_torch.models import streaming as tstreaming

    if model == "tiny_beam":
        jb, tb = tiny_emitting
        kw, use_lm, n, steps = dict(beam_width=3, max_iters=3,
                                    beam_buf_tokens=8), False, 3, 8
        audio = _noise(19, (n, steps * CHUNK))
    else:
        path = os.path.join(FIXTURES, "model_bpe.tar.gz")
        jb = JaxBundle.from_bundle(path, extract_to=str(tmp_path / "j"))
        tb = _port_bundle("model_bpe.tar.gz", tmp_path / "t")
        kw = dict(beam_width=3, lm_alpha=0.2) if model == "bpe_beam_lm" else {}
        use_lm, n, steps = True, 4, 14
        audio = np.zeros((n, steps * CHUNK), np.float32)
        audio[:, :16000] = golden_audio[2 : 2 + n]
    forced = []
    commit = tstreaming._beam_committed_prefix

    def counting(beam, force_margin=0):
        cap = beam.y_buf.shape[-1]
        forced.append(int((beam.y_len.max(1).values >= cap - force_margin).sum()))
        return commit(beam, force_margin)

    monkeypatch.setattr(tstreaming, "_beam_committed_prefix", counting)
    je = JaxEngine(jb, n_streams=n, scfg=JaxConfig(**kw), use_lm=use_lm)
    te = StreamingEngine(tb, n_streams=n, scfg=StreamingConfig(**kw),
                         use_lm=use_lm)
    fields = BEAM_FIELDS if te.beam else GREEDY_LM_FIELDS
    rng = np.random.default_rng(3)
    # no resets in the beam+LM case: they cut the golden speech short and
    # leave the all-blank hypothesis best, with nothing left to compare
    resets = model != "bpe_beam_lm"
    emitted = 0
    for k in range(steps):
        chunks = audio[:, None, k * CHUNK : (k + 1) * CHUNK]
        valid = rng.random(n) > 0.15
        reset = (rng.random(n) > 0.85) & (k > 2) & resets
        jt, jl = je.step_batch(chunks, valid, reset)
        tt, tl = te.step_batch(chunks, valid, reset)
        np.testing.assert_array_equal(tl, jl, err_msg=f"step {k}")
        np.testing.assert_array_equal(tt, jt, err_msg=f"step {k}")
        assert_state_equal(je.state.decode, te.state.decode,
                           [f for f in fields if f != "scores"], STATE_TOL)
        if te.beam:
            assert_state_equal(je.state.decode, te.state.decode, ["scores"],
                               SCORE_TOL)
        emitted += int(tl.sum())
    for i in range(n):
        je.flush_slot(i)
        te.flush_slot(i)
    assert te.emitted == je.emitted and te.outbox == je.outbox
    assert emitted + sum(len(e) for e in te.emitted) > 0
    assert (sum(forced) > 0) == (model == "tiny_beam")


def test_beam_flush_exact_and_needs_collected_steps(golden_audio, tmp_path):
    """The char golden bundle in a K-3 engine, no client padding: the
    final padded step and the flush of the best beam's tail give the
    exact transcript, twice on one slot (reuse after the flush). A flush
    with a dispatched step of the slot not yet collected raises."""
    bundle = _port_bundle("model.tar.gz", tmp_path)
    eng = StreamingEngine(bundle, n_streams=2,
                          scfg=StreamingConfig(beam_width=3))
    for i, want in ((2, "hello world"), (3, "stop now")):
        s = eng.open_slot()
        text = "".join(eng.feed(s, golden_audio[i, off : off + CHUNK])
                       for off in range(0, 16000, CHUNK))
        text += eng.finish_slot(s)
        eng.close_slot(s)
        assert text == want and eng.transcript(s) == want
    s = eng.open_slot()
    eng.append_samples(s, golden_audio[2, : 2 * CHUNK])
    pending = eng.step_dispatch()
    with pytest.raises(RuntimeError, match="not collected"):
        eng.flush_slot(s)
    eng.step_collect(pending)
    eng.flush_slot(s)


# ---- on the card -----------------------------------------------------------


@pytest.mark.cuda
def test_graph_replay_matches_uncaptured_step_on_cuda(tmp_path):
    """20 steps with ragged valid masks and resets: every step is one
    replay, whose tokens equal the uncaptured step function's on a copy
    of the state (and the state within 1e-6: the same kernels in the
    same order); then step_dispatch_chained(4) equals 4 steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bundle = ASRBundle.from_bundle(os.path.join(FIXTURES, "model.tar.gz"),
                                   extract_to=str(tmp_path), device="cuda")
    n = 8
    eng = StreamingEngine(bundle, n_streams=n)
    rng = np.random.default_rng(0)
    ref = eng.state.clone()
    for k in range(20):
        chunks = _noise(100 + k, (n, 1, CHUNK))
        valid = rng.random(n) > 0.2
        reset = rng.random(n) > 0.8
        toks, lens = eng.step_batch(chunks, valid, reset)
        with torch.no_grad():
            ref, packed = eng.step_fn(
                ref, torch.from_numpy(chunks).cuda(),
                torch.from_numpy(valid).cuda(), torch.from_numpy(reset).cuda())
        packed = packed.cpu().numpy()
        np.testing.assert_array_equal(lens, packed[:, -1])
        np.testing.assert_array_equal(toks, packed[:, :-1])
        for a, b in zip(_leaves(eng.state), _leaves(ref)):
            assert float((a.double() - b.double()).abs().max()) <= 1e-6
    assert eng.replays == eng.steps == 20

    def run(chained):
        e = StreamingEngine(bundle, n_streams=2)
        s = e.open_slot()
        e.append_samples(s, _noise(7, CHUNK * 4))
        if chained:
            e.step_collect(e.step_dispatch_chained(4))
        else:
            while e.step_ready():
                pass
        return list(e.emitted[s]), e.replays

    assert run(True) == run(False)


@pytest.mark.cuda
def test_bf16_graph_replay_matches_uncaptured_step_on_cuda(tmp_path):
    """The golden char model computing in bf16: its tower matrices cast
    at build, their products on the tensor cores inside the captured
    graph. 20 steps with ragged valid masks and resets, every step one
    replay whose tokens equal the uncaptured step function's on a copy
    of the state, and the state within 1e-6, as the float32 case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    golden = ASRBundle.from_bundle(os.path.join(FIXTURES, "model.tar.gz"),
                                   extract_to=str(tmp_path), device="cuda")
    conf = copy.deepcopy(golden.conf)
    conf["dtypes"]["compute"] = "bfloat16"
    model = Transducer(TransducerConfig.from_config(conf), device="cuda")
    model.load_state_dict(golden.model.state_dict())
    bundle = ASRBundle(conf, model, golden.lang, torch.device("cuda"))
    n = 8
    eng = StreamingEngine(bundle, n_streams=n)
    assert eng.tensor_core_weights == 2 * 2 + 2 + 3
    rng = np.random.default_rng(2)
    ref = eng.state.clone()
    total = 0
    for k in range(20):
        chunks = _noise(400 + k, (n, 1, CHUNK))
        valid = rng.random(n) > 0.2
        reset = rng.random(n) > 0.8
        toks, lens = eng.step_batch(chunks, valid, reset)
        with torch.no_grad():
            ref, packed = eng.step_fn(
                ref, torch.from_numpy(chunks).cuda(),
                torch.from_numpy(valid).cuda(), torch.from_numpy(reset).cuda())
        packed = packed.cpu().numpy()
        np.testing.assert_array_equal(lens, packed[:, -1])
        np.testing.assert_array_equal(toks, packed[:, :-1])
        for a, b in zip(_leaves(eng.state), _leaves(ref)):
            assert float((a.double() - b.double()).abs().max()) <= 1e-6
        total += int(lens.sum())
    assert eng.replays == eng.steps == 20 and total > 0


@pytest.mark.cuda
def test_mesh_engine_over_distinct_cards_matches_single_on_cuda(tmp_path):
    """A mesh engine over every visible card (at least two: one
    sub-engine, weights copy and CUDA graph a card) against engines of
    one card's share of the streams on cuda:0 (the same shapes, so the
    same kernels), 12 steps of ragged valid masks and resets: equal
    tokens and counts, one replay a card a step."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    bundle = ASRBundle.from_bundle(os.path.join(FIXTURES, "model.tar.gz"),
                                   extract_to=str(tmp_path), device="cuda:0")
    n = 4 * len(cards)
    parts = [StreamingEngine(bundle, n_streams=4) for _ in cards]
    meshed = StreamingEngine(bundle, n_streams=n,
                             mesh=make_mesh(data=len(cards), devices=cards))
    assert [str(sh.device) for sh in meshed._shards] == cards
    rng = np.random.default_rng(1)
    for k in range(12):
        chunks = _noise(200 + k, (n, 1, CHUNK))
        valid = rng.random(n) > 0.2
        reset = rng.random(n) > 0.8
        got = [e.step_batch(chunks[i * 4:(i + 1) * 4], valid[i * 4:(i + 1) * 4],
                            reset[i * 4:(i + 1) * 4])
               for i, e in enumerate(parts)]
        t1, l1 = (np.concatenate([g[j] for g in got]) for j in (0, 1))
        t2, l2 = meshed.step_batch(chunks, valid, reset)
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(t1, t2)
    assert meshed.replays == 12 * len(cards)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["beam_lm", "greedy_lm"])
def test_beam_and_lm_graph_replay_matches_uncaptured_step_on_cuda(mode, tmp_path):
    """The BPE golden bundle with its LM, K 3 (alpha 0.2) or greedy: 12
    steps with ragged valid masks and resets, every step one replay
    whose tokens equal the uncaptured step function's on a copy of the
    state (and the decode state within 1e-6, as the greedy case)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bundle = ASRBundle.from_bundle(os.path.join(FIXTURES, "model_bpe.tar.gz"),
                                   extract_to=str(tmp_path), device="cuda")
    n = 4
    kw = dict(beam_width=3, lm_alpha=0.2) if mode == "beam_lm" else {}
    eng = StreamingEngine(bundle, n_streams=n, scfg=StreamingConfig(**kw),
                          use_lm=True)
    rng = np.random.default_rng(1)
    ref = eng.state.clone()
    for k in range(12):
        chunks = _noise(200 + k, (n, 1, CHUNK))
        valid = rng.random(n) > 0.2
        reset = rng.random(n) > 0.9
        toks, lens = eng.step_batch(chunks, valid, reset)
        with torch.no_grad():
            ref, packed = eng.step_fn(
                ref, torch.from_numpy(chunks).cuda(),
                torch.from_numpy(valid).cuda(), torch.from_numpy(reset).cuda())
        packed = packed.cpu().numpy()
        np.testing.assert_array_equal(lens, packed[:, -1])
        np.testing.assert_array_equal(toks, packed[:, :-1])
        for a, b in zip(_leaves(eng.state.decode), _leaves(ref.decode)):
            assert float((a.double() - b.double()).abs().max()) <= 1e-6
    assert eng.replays == eng.steps == 12
