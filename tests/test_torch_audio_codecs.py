"""The port's audio codecs (libreasr_tpu_torch.data.audio over
csrc/audio_codecs.cpp) against the JAX package's native ones, on files
the tests write themselves.

FLAC: tests/helpers/flac_writer.py writes every subframe type (CONSTANT,
VERBATIM, FIXED orders 0-4, LPC), Rice partitions with 4- and 5-bit
parameters and escaped (raw) partitions, wasted bits, block sizes that
are no power of two, mono and stereo in each channel mode. FLAC is
lossless: both decoders must give the source samples exactly (tolerance
0), and the same STREAMINFO MD5. MP3 and Ogg are decoded by the host's
libraries in both packages, so a file decodes to the same floats in
either, exactly (tolerance 0). The MP3/Ogg cases skip on a host without
those libraries, through have_mp3/have_ogg, as the JAX tests do.
"""

import os

import numpy as np
import pytest

from helpers.flac_writer import write_flac
from libreasr_tpu_torch.data import audio as port

SR = 16000


def _jax():
    from libreasr_tpu.data import audio as jax_audio

    return jax_audio


def _signals(n=4100, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    left = np.sin(t / 7.0) * 8000 + rng.normal(0, 300, n)
    left[900:2100] = -5  # a constant stretch: CONSTANT subframes
    right = np.cos(t / 13.0) * 6000 + rng.normal(0, 150, n)
    clip = lambda x: np.clip(np.round(x), -32768, 32767).astype(np.int64)  # noqa: E731
    return clip(left), clip(right)


MONO_CASES = {
    "verbatim": dict(method="verbatim"),
    **{f"fixed{k}": dict(method=f"fixed{k}") for k in range(5)},
    "lpc": dict(method="lpc", lpc_order=8),
    "lpc_order1_low_precision": dict(method="lpc", lpc_order=1, lpc_precision=5),
    "rice5_escape": dict(method="lpc", rice5=True, escape=True,
                         partition_order=4, blocksize=1024),
    "odd_blocksize": dict(method="fixed2", blocksize=999, partition_order=3),
    "short_blocks": dict(method="lpc", lpc_order=4, blocksize=37),
    "no_constant": dict(method="fixed1", constant=False),
}
STEREO_MODES = ["independent", "left_side", "right_side", "mid_side"]


def _check_same(path, want):
    jx = _jax()
    a, sr_a, md5_a = jx.read_audio(path, return_md5=True)
    b, sr_b, md5_b = port.read_audio(path, return_md5=True)
    assert sr_a == sr_b == SR
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(b, a)
    assert md5_a == md5_b
    np.testing.assert_array_equal(np.round(b * 32768).astype(np.int64),
                                  np.atleast_2d(want))
    assert port.verify_flac_md5(path) and jx.verify_flac_md5(path)
    return md5_b


@pytest.mark.parametrize("case", sorted(MONO_CASES))
def test_flac_mono_subframes_match_jax(tmp_path, case):
    left, _ = _signals()
    path = str(tmp_path / f"{case}.flac")
    md5 = write_flac(path, left, SR, **MONO_CASES[case])
    assert _check_same(path, left) == md5


def test_flac_wasted_bits_match_jax(tmp_path):
    left, _ = _signals()
    x = (left // 8) * 8  # 3 wasted bits in every block but the constant one
    path = str(tmp_path / "wasted.flac")
    write_flac(path, x, SR, method="lpc")
    _check_same(path, x)


@pytest.mark.parametrize("mode", STEREO_MODES)
def test_flac_stereo_modes_match_jax(tmp_path, mode):
    left, right = _signals(seed=1)
    x = np.stack([left, right])
    path = str(tmp_path / f"{mode}.flac")
    write_flac(path, x, SR, method="lpc", stereo=mode, blocksize=1000)
    _check_same(path, x)


def test_flac_errors_raise_in_both(tmp_path):
    left, _ = _signals()
    good = str(tmp_path / "good.flac")
    write_flac(good, left, SR)
    raw = open(good, "rb").read()
    garbage = str(tmp_path / "garbage.flac")
    open(garbage, "wb").write(b"\x00\x01not-a-flac" * 64)
    badsync = str(tmp_path / "badsync.flac")
    # the first frame's sync code broken (STREAMINFO is 4 + 4 + 34 bytes)
    open(badsync, "wb").write(raw[:42] + b"\x00\x00" + raw[44:])
    for path in (garbage, badsync, str(tmp_path / "missing.flac")):
        with pytest.raises(_jax().AudioReadError):
            _jax().read_audio(path)
        with pytest.raises(port.AudioReadError):
            port.read_audio(path)


def test_flac_truncated_decodes_as_jax(tmp_path):
    """A file cut mid-frame: the decoders stop (or refuse) at the same
    place."""
    left, _ = _signals()
    path = str(tmp_path / "whole.flac")
    write_flac(path, left, SR, blocksize=512)
    raw = open(path, "rb").read()
    cut = str(tmp_path / "cut.flac")
    open(cut, "wb").write(raw[: len(raw) * 2 // 3])
    try:
        want = _jax().read_audio(cut)
    except _jax().AudioReadError:
        with pytest.raises(port.AudioReadError):
            port.read_audio(cut)
        return
    got = port.read_audio(cut)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])


def _tone(n, sr=SR, f1=440.0, f2=1330.0):
    t = np.arange(n) / sr
    return (0.4 * np.sin(2 * np.pi * f1 * t)
            + 0.2 * np.sin(2 * np.pi * f2 * t)).astype(np.float32)


def _need(kind):
    if kind == "mp3" and not port.have_mp3():
        pytest.skip("host has no libmpg123/libmp3lame")
    if kind == "ogg" and not port.have_ogg():
        pytest.skip("host has no libvorbis")


def test_codec_probes_agree_with_jax():
    assert port.have_mp3() == _jax().have_mp3()
    assert port.have_ogg() == _jax().have_ogg()


@pytest.mark.parametrize("kind,ext", [("mp3", ".mp3"), ("ogg", ".ogg"),
                                      ("ogg", ".oga")])
def test_compressed_written_by_either_decode_alike(tmp_path, kind, ext):
    _need(kind)
    jx = _jax()
    x = _tone(2 * SR)
    for writer, name in ((jx, "jax"), (port, "port")):
        path = str(tmp_path / f"{name}{ext}")
        fn = getattr(writer, f"write_{kind}")
        fn(path.replace(".oga", ".ogg"), x, SR)
        if ext == ".oga":
            os.rename(path.replace(".oga", ".ogg"), path)
        a, sr_a = jx.read_audio(path)
        b, sr_b = port.read_audio(path)
        assert sr_a == sr_b == SR and b.shape[0] == 1
        assert abs(b.shape[1] - len(x)) <= 2048
        np.testing.assert_array_equal(b, a)
        m = min(b.shape[1], len(x))
        if kind == "ogg":  # Vorbis has no codec delay: sample-aligned
            assert float(np.sqrt(np.mean((b[0, :m] - x[:m]) ** 2))) < 0.02


def test_mp3_encoders_write_the_same_bytes(tmp_path):
    """Both packages drive libmp3lame with the same settings."""
    _need("mp3")
    x = _tone(SR)
    a, b = str(tmp_path / "a.mp3"), str(tmp_path / "b.mp3")
    _jax().write_mp3(a, x, SR)
    port.write_mp3(b, x, SR)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("ext", [".mp3", ".ogg"])
def test_garbage_compressed_raises(tmp_path, ext):
    _need(ext[1:])
    p = str(tmp_path / f"garbage{ext}")
    open(p, "wb").write(b"\x00\x01garbage-not-audio" * 64)
    with pytest.raises(port.AudioReadError):
        port.read_audio(p)


def test_truncated_ogg_matches_jax(tmp_path):
    _need("ogg")
    p = str(tmp_path / "whole.ogg")
    port.write_ogg(p, _tone(2 * SR), SR)
    raw = open(p, "rb").read()
    cut = str(tmp_path / "cut.ogg")
    open(cut, "wb").write(raw[: len(raw) // 2])
    try:
        want = _jax().read_audio(cut)
    except _jax().AudioReadError:
        with pytest.raises(port.AudioReadError):
            port.read_audio(cut)
        return
    got = port.read_audio(cut)
    assert got[1] == want[1] == SR and got[0].shape[1] <= 2 * SR
    np.testing.assert_array_equal(got[0], want[0])


def test_chained_ogg_same_format_matches_jax(tmp_path):
    _need("ogg")
    pa, pb = str(tmp_path / "a.ogg"), str(tmp_path / "b.ogg")
    port.write_ogg(pa, _tone(SR, f1=440.0), SR)
    port.write_ogg(pb, _tone(SR, f1=880.0), SR)
    chained = str(tmp_path / "chained.ogg")
    open(chained, "wb").write(open(pa, "rb").read() + open(pb, "rb").read())
    got, sr = port.read_audio(chained)
    want, _ = _jax().read_audio(chained)
    assert sr == SR and abs(got.shape[1] - 2 * SR) <= 2048
    np.testing.assert_array_equal(got, want)


def test_chained_ogg_rate_change_refused(tmp_path):
    _need("ogg")
    pa, pb = str(tmp_path / "a.ogg"), str(tmp_path / "b.ogg")
    port.write_ogg(pa, _tone(SR), SR)
    port.write_ogg(pb, _tone(8000, sr=8000), 8000)
    chained = str(tmp_path / "chained.ogg")
    open(chained, "wb").write(open(pa, "rb").read() + open(pb, "rb").read())
    with pytest.raises(port.AudioReadError):
        port.read_audio(chained)


def test_unwritable_encode_path_raises(tmp_path):
    bad = str(tmp_path / "no-such-dir" / "out")
    pcm = np.zeros(1600, np.float32)
    if not (port.have_mp3() or port.have_ogg()):
        pytest.skip("host has no mp3/ogg encoders")
    for _ in range(3):
        if port.have_mp3():
            with pytest.raises(port.AudioReadError):
                port.write_mp3(bad + ".mp3", pcm, SR)
        if port.have_ogg():
            with pytest.raises(port.AudioReadError):
                port.write_ogg(bad + ".ogg", pcm, SR)


def test_unsupported_extension_raises(tmp_path):
    p = str(tmp_path / "x.m4a")
    open(p, "wb").write(b"\x00" * 64)
    with pytest.raises(port.AudioReadError):
        port.read_audio(p)


def test_wav_return_md5_is_none(tmp_path):
    import wave

    p = str(tmp_path / "a.wav")
    with wave.open(p, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(np.arange(-50, 50, dtype=np.int16).tobytes())
    pcm, sr, md5 = port.read_audio(p, return_md5=True)
    assert sr == SR and md5 is None and pcm.shape == (1, 100)


def _riff(fmt_tag, ch, sr, bits, payload: bytes, extra_chunk=True) -> bytes:
    fmt = (fmt_tag.to_bytes(2, "little") + ch.to_bytes(2, "little")
           + sr.to_bytes(4, "little") + (sr * ch * bits // 8).to_bytes(4, "little")
           + (ch * bits // 8).to_bytes(2, "little") + bits.to_bytes(2, "little"))
    body = b"WAVE" + b"fmt " + len(fmt).to_bytes(4, "little") + fmt
    if extra_chunk:  # an odd-sized chunk: skipped with its pad byte
        body += b"LIST" + (3).to_bytes(4, "little") + b"abc\x00"
    body += b"data" + len(payload).to_bytes(4, "little") + payload
    return b"RIFF" + (len(body)).to_bytes(4, "little") + body


@pytest.mark.parametrize("fmt_tag,bits,kind", [(1, 8, "u1"), (1, 16, "<i2"),
                                               (1, 32, "<i4"), (3, 32, "<f4")])
@pytest.mark.parametrize("ch", [1, 2])
def test_wav_formats_match_jax_native(tmp_path, fmt_tag, bits, kind, ch):
    """The port's Python WAV reader against the JAX package's native one
    (la_read_wav), exactly: PCM 8/16/32 bit and float32, mono and
    stereo, an odd chunk before the data, a trailing partial frame."""
    rng = np.random.default_rng(bits + ch)
    n = 1001 * ch + (1 if ch == 2 else 0)
    if kind == "<f4":
        x = rng.uniform(-1, 1, n).astype(kind)
    else:
        info = np.iinfo(np.dtype(kind))
        x = rng.integers(info.min, info.max, n, endpoint=True).astype(kind)
    p = str(tmp_path / "a.wav")
    open(p, "wb").write(_riff(fmt_tag, ch, 22050, bits, x.tobytes()))
    want, sr_w = _jax().read_audio(p)
    got, sr_g = port.read_audio(p)
    assert sr_g == sr_w == 22050 and got.shape == (ch, 1001)
    np.testing.assert_array_equal(got, want)


def test_bad_wavs_raise(tmp_path):
    good = _riff(1, 1, 16000, 16, np.arange(100, dtype="<i2").tobytes(), False)
    for name, raw in (("garbage", b"\x00" * 64), ("truncated", good[:-20]),
                      ("adpcm", _riff(2, 1, 16000, 4, b"\x00" * 64)),
                      ("empty", _riff(1, 1, 16000, 16, b""))):
        p = str(tmp_path / f"{name}.wav")
        open(p, "wb").write(raw)
        with pytest.raises(port.AudioReadError):
            port.read_audio(p)
        with pytest.raises(_jax().AudioReadError):
            _jax().read_audio(p)
