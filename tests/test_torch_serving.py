"""The port's serving stack (libreasr_tpu_torch.serving) on the CPU:
the wire codec byte for byte against the JAX package's, the gRPC server
on the golden bundle (unary and streaming exact, concurrent streams,
slots exhausted; beam search with the end-of-stream flush, and beam
search with LM fusion on the BPE bundle, unary and streaming), the
`main` flags, the WebSocket bridge end to end, and the two pieces
the servicer runs on every message: `resample` against the JAX
package's native resampler and the char vocabulary's specials."""

import asyncio
import os
import socket
import struct
import threading
import time

import grpc
import numpy as np
import pytest

from libreasr_tpu.data import audio as jaudio
from libreasr_tpu.data.language import get_language as jax_language
from libreasr_tpu.serving import proto as jproto
from libreasr_tpu_torch.api import ASRBundle
from libreasr_tpu_torch.data import audio as taudio
from libreasr_tpu_torch.data.audio import read_wav
from libreasr_tpu_torch.data.language import get_language
from libreasr_tpu_torch.models.streaming import StreamingConfig, StreamingEngine
from libreasr_tpu_torch.serving import proto
from libreasr_tpu_torch.parallel.mesh import make_mesh
from libreasr_tpu_torch.serving.server import ASRServicer, make_server

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
CHUNK = 1280


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    bundle = ASRBundle.from_bundle(
        os.path.join(FIXTURES, "model.tar.gz"),
        extract_to=str(tmp_path_factory.mktemp("serving")), device="cpu")
    audio = np.zeros((8, 16000), np.float32)
    for i in range(8):
        audio[i] = read_wav(os.path.join(FIXTURES, f"s-{i:03d}.wav"))[0][0]
    return bundle, audio


@pytest.fixture(scope="module")
def live_server(golden):
    bundle, _ = golden
    port = _free_port()
    server, servicer = make_server(bundle, port,
                                   engine=StreamingEngine(bundle, n_streams=4))
    server.start()
    yield port, servicer
    server.stop(0)
    servicer.stepper.shutdown()


def _stream_call(port):
    channel = grpc.insecure_channel(f"localhost:{port}")
    return channel, channel.stream_stream(
        proto.METHOD_TRANSCRIBE_STREAM,
        request_serializer=proto.Audio.SerializeToString,
        response_deserializer=proto.Transcript.FromString,
    )


def _chunks(pcm, delay=0.0):
    for off in range(0, len(pcm), CHUNK):
        yield proto.Audio(data=pcm[off : off + CHUNK].tobytes(), sr=16000)
        if delay:
            time.sleep(delay)


# ---- wire codec ------------------------------------------------------------


@pytest.mark.parametrize("data,sr", [
    (b"", 0), (b"", 16000), (np.arange(10, dtype=np.float32).tobytes(), 16000),
    (bytes(range(256)) * 3, 8000), (b"\x00", -1),
])
def test_audio_bytes_equal_jax(data, sr):
    ours = proto.Audio(data=data, sr=sr).SerializeToString()
    assert ours == jproto.Audio(data=data, sr=sr).SerializeToString()
    back = proto.Audio.FromString(ours)
    want = jproto.Audio.FromString(ours)
    assert (back.data, back.sr) == (want.data, want.sr)


@pytest.mark.parametrize("text", ["", "hello wörld", "x" * 300])
def test_transcript_bytes_equal_jax(text):
    ours = proto.Transcript(data=text).SerializeToString()
    assert ours == jproto.Transcript(data=text).SerializeToString()
    assert proto.Transcript.FromString(ours).data == text
    assert (proto.SERVICE, proto.METHOD_TRANSCRIBE, proto.METHOD_TRANSCRIBE_STREAM) \
        == (jproto.SERVICE, jproto.METHOD_TRANSCRIBE, jproto.METHOD_TRANSCRIBE_STREAM)


# ---- the gRPC server ---------------------------------------------------------


def test_grpc_wire_exact(live_server, golden):
    """Unary Transcribe, and TranscribeStream with no trailing padding:
    the server's end-of-stream flush pads the frontend remainder and
    drains the final tokens."""
    port, _ = live_server
    _, audio = golden
    channel, stream = _stream_call(port)
    unary = channel.unary_unary(
        proto.METHOD_TRANSCRIBE,
        request_serializer=proto.Audio.SerializeToString,
        response_deserializer=proto.Transcript.FromString,
    )
    assert unary(proto.Audio(data=audio[2].tobytes(), sr=16000)).data == "hello world"
    assert "".join(t.data for t in stream(_chunks(audio[3]))) == "stop now"
    channel.close()


def test_grpc_wire_concurrent_exact(live_server, golden):
    """Two concurrent streams each receive their own exact transcript,
    also text decoded in a step the other stream's arrivals drove."""
    port, _ = live_server
    _, audio = golden
    channel, stream = _stream_call(port)
    results = {}

    def run(name, i, delay):
        results[name] = "".join(t.data for t in stream(_chunks(audio[i], delay)))

    threads = [threading.Thread(target=run, args=("a", 2, 0.0)),
               threading.Thread(target=run, args=("b", 3, 0.02))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert results == {"a": "hello world", "b": "stop now"}
    channel.close()


def test_resource_exhausted_when_slots_are_full(golden):
    bundle, audio = golden
    port = _free_port()
    server, servicer = make_server(bundle, port,
                                   engine=StreamingEngine(bundle, n_streams=1))
    server.start()
    release = threading.Event()
    try:
        channel, stream = _stream_call(port)

        def hold():
            yield proto.Audio(data=audio[0, :CHUNK].tobytes(), sr=16000)
            release.wait(30)

        first = stream(hold())
        deadline = time.time() + 10
        while not servicer.engine.active.any() and time.time() < deadline:
            time.sleep(0.01)
        assert servicer.engine.active.any()
        with pytest.raises(grpc.RpcError) as err:
            list(stream(_chunks(audio[1])))
        assert err.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        release.set()
        list(first)
        channel.close()
    finally:
        release.set()
        server.stop(0)
        servicer.stepper.shutdown()


def test_servicer_takes_beam_and_lm_settings(golden):
    """The servicer builds a beam engine of beam_width, or else of the
    bundle's stream.beam_width, fuses the LM only when the bundle has
    one, and takes the fusion weights from its arguments, else from the
    stream block, else 0.1 / 0.0 (JAX's precedence)."""
    bundle, _ = golden
    stream = bundle.conf.get("stream")
    made = []
    try:
        s = ASRServicer(bundle, beam_width=4, use_lm=True)
        made.append(s)
        assert s.engine.beam and s.engine.scfg.beam_width == 4
        assert s.engine.fns.lm_step is None  # the char bundle has no LM
        assert (s.lm_alpha, s.lm_beta, s.engine.scfg.lm_alpha) == (0.1, 0.0, 0.1)
        bundle.conf["stream"] = {"beam_width": 2, "lm_alpha": 0.3,
                                 "lm_beta": 0.4, "max_streams": 2}
        s = ASRServicer(bundle)
        made.append(s)
        assert s.engine.n == 2 and s.engine.scfg.beam_width == 2
        assert (s.lm_alpha, s.lm_beta) == (0.3, 0.4) and s.beam_width == 0
        s = ASRServicer(bundle, beam_width=3, lm_alpha=0.5)
        made.append(s)
        assert s.engine.scfg.beam_width == 3 and s.engine.scfg.lm_alpha == 0.5
        assert (s.lm_alpha, s.lm_beta) == (0.5, 0.4)
    finally:
        if stream is None:
            bundle.conf.pop("stream", None)
        else:
            bundle.conf["stream"] = stream
        for s in made:
            s.stepper.shutdown()


def test_grpc_server_on_mesh(golden):
    """tests/test_serving.py:141 through the port: the server's engine
    sharded over a data-8 mesh of CPU devices (one sub-engine a stream)
    delivers the exact golden transcripts over the wire, two streams at
    once, each on its own device."""
    bundle, audio = golden
    port = _free_port()
    engine = StreamingEngine(bundle, n_streams=8,
                             mesh=make_mesh(data=8, devices=["cpu"] * 8))
    server, servicer = make_server(bundle, port, engine=engine)
    server.start()
    try:
        channel, stream = _stream_call(port)
        results = {}

        def run(name, i, delay):
            results[name] = "".join(t.data for t in stream(_chunks(audio[i], delay)))

        threads = [threading.Thread(target=run, args=("a", 2, 0.0)),
                   threading.Thread(target=run, args=("b", 3, 0.02))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert results == {"a": "hello world", "b": "stop now"}
        assert all(sh.steps == engine.steps for sh in engine._shards)
        channel.close()
    finally:
        server.stop(0)
        servicer.stepper.shutdown()


def test_grpc_wire_beam_flush_exact(golden):
    """tests/test_golden_decode.py::test_grpc_wire_beam_flush_exact: a
    K-3 engine over the wire with no client padding; the end-of-stream
    flush runs the final padded step and commits the beam's uncommitted
    tail before the call closes; a second stream reuses the slot."""
    bundle, audio = golden
    port = _free_port()
    engine = StreamingEngine(bundle, n_streams=2,
                             scfg=StreamingConfig(sr=16000, beam_width=3))
    server, servicer = make_server(bundle, port, engine=engine)
    server.start()
    try:
        channel, stream = _stream_call(port)
        assert "".join(t.data for t in stream(_chunks(audio[2]))) == "hello world"
        assert "".join(t.data for t in stream(_chunks(audio[3]))) == "stop now"
        channel.close()
    finally:
        server.stop(0)
        servicer.stepper.shutdown()


@pytest.fixture(scope="module")
def beam_lm_server(tmp_path_factory, golden):
    """tests/test_serving.py:318 through the port: the BPE golden bundle
    (it ships an LM) behind a server whose engine beams (K 3) with LM
    fusion (alpha 0.2), unary beam+LM flags (K 3, alpha 0.2, beta 0.6)."""
    bundle = ASRBundle.from_bundle(
        os.path.join(FIXTURES, "model_bpe.tar.gz"),
        extract_to=str(tmp_path_factory.mktemp("beam_lm")), device="cpu")
    assert bundle.lm is not None
    engine = StreamingEngine(bundle, n_streams=4, use_lm=True, scfg=StreamingConfig(
        sr=bundle.frontend.sr, beam_width=3, lm_alpha=0.2))
    port = _free_port()
    server, servicer = make_server(bundle, port, engine=engine, beam_width=3,
                                   use_lm=True, lm_alpha=0.2, lm_beta=0.6)
    server.start()
    yield port
    server.stop(0)
    servicer.stepper.shutdown()


def test_unary_beam_lm_over_wire(beam_lm_server, golden):
    _, audio = golden
    channel = grpc.insecure_channel(f"localhost:{beam_lm_server}")
    unary = channel.unary_unary(
        proto.METHOD_TRANSCRIBE,
        request_serializer=proto.Audio.SerializeToString,
        response_deserializer=proto.Transcript.FromString,
    )
    out = unary(proto.Audio(data=audio[2].tobytes(), sr=16000))
    channel.close()
    assert out.data == "hello world"


def test_stream_beam_lm_over_wire(beam_lm_server, golden):
    """Prefix-agreement commits and the end-of-stream beam flush deliver
    the exact golden transcript over gRPC."""
    _, audio = golden
    channel, stream = _stream_call(beam_lm_server)

    def gen():
        yield from _chunks(audio[2])
        yield proto.Audio(data=np.zeros(CHUNK, np.float32).tobytes(), sr=16000)

    text = "".join(t.data for t in stream(gen()))
    channel.close()
    assert text.endswith("hello world")


def test_main_takes_beam_and_lm_flags(monkeypatch):
    """`main --beam 4 --use-lm --lm-alpha --lm-beta` reaches the
    servicer: unary beam+LM with those weights, a K-4 engine fusing the
    bundle's LM (warmed up before the server starts)."""
    from libreasr_tpu_torch.serving import server as srv

    made = {}
    real = srv.make_server

    class Idle:
        def start(self):
            made["started"] = True

        def wait_for_termination(self):
            pass

    def fake_make_server(*args, **kw):
        server, servicer = real(*args, **kw)
        made["servicer"] = servicer
        return Idle(), servicer

    monkeypatch.setattr(srv, "make_server", fake_make_server)
    srv.main(["--bundle", os.path.join(FIXTURES, "model_bpe.tar.gz"),
              "--port", str(_free_port()), "--beam", "4", "--use-lm",
              "--lm-alpha", "0.2", "--lm-beta", "0.6", "--device", "cpu"])
    s = made["servicer"]
    try:
        assert made["started"] and (s.beam_width, s.use_lm) == (4, True)
        assert (s.lm_alpha, s.lm_beta) == (0.2, 0.6)
        eng = s.engine
        assert eng.scfg.beam_width == 4 and eng.fns.lm_step is s.bundle.lm
        assert eng.scfg.lm_alpha == 0.2 and eng.steps > 0
    finally:
        s.stepper.shutdown()


def test_servicer_resamples_as_jax(golden):
    """A message at another rate is resampled to the bundle's before it
    reaches the model, with JAX's resampler."""
    bundle, audio = golden
    servicer = ASRServicer(bundle, engine=StreamingEngine(bundle, n_streams=1))
    try:
        pcm8k = jaudio.resample(audio[2], 16000, 8000)
        got = servicer._pcm(proto.Audio(data=pcm8k.tobytes(), sr=8000))
        np.testing.assert_array_equal(got, jaudio.resample(pcm8k, 8000, 16000))
    finally:
        servicer.stepper.shutdown()


# ---- the WebSocket bridge --------------------------------------------------


def test_bridge_frame_parse():
    from libreasr_tpu_torch.serving.bridge import parse_frame

    payload = np.ones(4, np.float32).tobytes()
    raw = b"en\x00\x00" + struct.pack("<f", 16000.0) + payload
    assert parse_frame(raw) == ("en", 16000, payload)


def _run_bridge(static_path=None):
    import tornado.ioloop

    from libreasr_tpu_torch.serving.bridge import make_app

    port = _free_port()
    holder = {}

    def run():
        asyncio.set_event_loop(asyncio.new_event_loop())
        make_app(static_path=static_path).listen(port)
        holder["loop"] = tornado.ioloop.IOLoop.current()
        holder["loop"].start()

    threading.Thread(target=run, daemon=True).start()
    time.sleep(1.0)
    return port, holder


def test_bridge_serves_web_client():
    import urllib.request

    port, holder = _run_bridge(static_path="apps/web")
    try:
        html = urllib.request.urlopen(f"http://localhost:{port}/", timeout=5).read()
    finally:
        holder["loop"].add_callback(holder["loop"].stop)
    html = html.decode()
    assert "LibreASR" in html and "asupersecretwebsocketpath345" in html


def test_ws_bridge_e2e(live_server, golden, monkeypatch):
    """Browser-protocol WS frames -> bridge -> gRPC -> the port's engine
    -> text."""
    from websockets.sync.client import connect

    from libreasr_tpu_torch.serving import bridge

    port, _ = live_server
    _, audio = golden
    monkeypatch.setattr(bridge, "LANG_PORTS", {"en": port})
    ws_port, holder = _run_bridge()
    got = []
    try:
        with connect(f"ws://localhost:{ws_port}{bridge.WS_PATH}") as ws:
            header = b"en\x00\x00" + struct.pack("<f", 16000.0)
            for off in range(0, 16000, CHUNK):
                ws.send(header + audio[2, off : off + CHUNK].tobytes())
            ws.send(header + np.zeros(CHUNK, np.float32).tobytes())
            try:
                while "hello world" not in "".join(got):
                    got.append(ws.recv(timeout=3.0))
            except TimeoutError:
                pass
    finally:
        holder["loop"].add_callback(holder["loop"].stop)
    assert "".join(got) == "hello world"


# ---- what the servicer runs on every message ----------------------------------


@pytest.mark.parametrize("sr_in,sr_out", [(8000, 16000), (22050, 16000),
                                          (44100, 16000), (48000, 16000),
                                          (16000, 8000)])
def test_resample_equals_jax_native(sr_in, sr_out):
    """The port's numpy copy of la_resample against the JAX package's
    native library (built on demand with g++): same lengths, within 1e-6
    (both accumulate in float64; only the order of the sums may differ)."""
    assert jaudio.audio_lib() is not None  # the native path, not scipy
    rng = np.random.default_rng(sr_in)
    x = (rng.standard_normal((2, sr_in)) * 0.1).astype(np.float32)
    want, got = jaudio.resample(x, sr_in, sr_out), taudio.resample(x, sr_in, sr_out)
    assert got.shape == want.shape == (2, sr_out)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(taudio.resample(x[0], sr_in, sr_out), want[0],
                               rtol=0, atol=1e-6)


def test_char_language_specials_equal_jax():
    lang, _ = get_language()
    jlang, _ = jax_language()
    assert (lang.blank, lang.sos, lang.eos) == (jlang.blank, jlang.sos, jlang.eos) \
        == (0, 1, 2)
    ids = [lang.t2i[c] for c in "hi"] + [lang.eos] + [lang.t2i["x"]]
    assert lang.denumericalize(ids) == jlang.denumericalize(ids) == "hi"
