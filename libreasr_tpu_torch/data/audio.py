"""Audio reading, writing and resampling.

WAV (PCM 8, 16 and 32 bit, float32) is read in Python. FLAC, MP3 and
Ogg/Vorbis go through the port's host codec library (csrc/
audio_codecs.cpp, built with g++ at first use): FLAC by its own decoder,
MP3 and Ogg by the host's codec libraries, which it opens with dlopen
(`have_mp3` / `have_ogg` say whether they are there). A file that does
not decode raises AudioReadError; nothing falls back to another reader.
`resample` is a numpy copy of the JAX package's native resampler
(native/audio.cpp, `la_resample`): a rational polyphase Kaiser-windowed
sinc with float64 taps and accumulation, so that both packages hear the
same samples.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
from functools import lru_cache

import numpy as np


class AudioReadError(RuntimeError):
    pass


# (format tag, bits) -> (numpy sample type, offset, scale): PCM 8 (unsigned),
# 16 and 32 bit, and IEEE float32 (tag 3), as the JAX package's native
# reader (la_read_wav) converts them, in float32
_WAV_CODECS = {(1, 8): ("u1", 128.0, 1 / 128.0), (1, 16): ("<i2", 0.0, 1 / 32768.0),
               (1, 32): ("<i4", 0.0, 1 / 2147483648.0), (3, 32): ("<f4", 0.0, 1.0)}


def read_wav(path: str):
    """-> (pcm [C, S] float32, sr). The RIFF chunks are walked as the JAX
    package's native reader walks them: the last `fmt ` and `data` chunks
    count, other chunks are skipped with their pad byte, a truncated data
    chunk raises, and a trailing partial frame is dropped."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        raise AudioReadError(f"cannot read {path}: {e}") from e
    if len(raw) < 12 or raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise AudioReadError(f"not a RIFF/WAVE file: {path}")
    fmt = ch = bits = sr = 0
    data = b""
    pos = 12
    while pos + 8 <= len(raw):
        cid, size = raw[pos: pos + 4], int.from_bytes(raw[pos + 4: pos + 8], "little")
        pos += 8
        if cid == b"fmt ":
            head = raw[pos: pos + min(size, 40)]
            if len(head) < min(size, 40) or len(head) < 16:
                raise AudioReadError(f"truncated fmt chunk: {path}")
            fmt, ch = int.from_bytes(head[0:2], "little"), int.from_bytes(head[2:4], "little")
            sr, bits = int.from_bytes(head[4:8], "little"), int.from_bytes(head[14:16], "little")
            pos += size
        elif cid == b"data":
            data = raw[pos: pos + size]
            if len(data) != size:
                raise AudioReadError(f"truncated data chunk: {path}")
            pos += size
        else:
            pos += size + (size & 1)
    if not data or ch == 0:
        raise AudioReadError(f"no audio data in {path}")
    codec = _WAV_CODECS.get((fmt, bits))
    if codec is None:
        raise AudioReadError(f"unsupported wav format {fmt} / {bits} bit in {path}")
    kind, offset, scale = codec
    x = np.frombuffer(data, kind, count=len(data) // np.dtype(kind).itemsize)
    frames = len(x) // ch
    x = x[: frames * ch].astype(np.float32)
    if offset:
        x = x - np.float32(offset)
    if scale != 1.0:
        x = x * np.float32(scale)
    return x.reshape(frames, ch).T.copy(), sr


@lru_cache(maxsize=1)
def _codecs() -> ctypes.CDLL:
    """The host codec library (csrc/audio_codecs.cpp), built at first
    use; a failed build raises."""
    from ..ops.kernels.build import load_host

    lib = load_host("audio_codecs")
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    fp = ctypes.POINTER(ctypes.c_float)
    reader = [ctypes.c_char_p, ctypes.POINTER(fp), i64p, i32p, i32p]
    lib.la_read_flac.argtypes = reader + [ctypes.c_char_p]
    lib.la_read_mp3.argtypes = reader
    lib.la_read_ogg.argtypes = reader
    lib.la_write_mp3.argtypes = [ctypes.c_char_p, fp, ctypes.c_int64,
                                 ctypes.c_int32, ctypes.c_int32]
    lib.la_write_ogg.argtypes = [ctypes.c_char_p, fp, ctypes.c_int64,
                                 ctypes.c_int32, ctypes.c_float]
    lib.la_free.argtypes = [fp]
    for fn in (lib.la_read_flac, lib.la_read_mp3, lib.la_read_ogg,
               lib.la_write_mp3, lib.la_write_ogg, lib.la_have_mp3,
               lib.la_have_ogg):
        fn.restype = ctypes.c_int32
    return lib


def _decode(fn, path: str, want_md5: bool):
    """-> (pcm [C, S] float32, sr, STREAMINFO md5 or None) of one of the
    library's readers."""
    out = ctypes.POINTER(ctypes.c_float)()
    n, sr, ch = ctypes.c_int64(), ctypes.c_int32(), ctypes.c_int32()
    args = [path.encode(), ctypes.byref(out), ctypes.byref(n),
            ctypes.byref(sr), ctypes.byref(ch)]
    md5 = ctypes.create_string_buffer(16) if want_md5 else None
    if want_md5:
        args.append(md5)
    rc = fn(*args)
    if rc != 0:
        raise AudioReadError(f"decode failed rc={rc}: {path}")
    try:
        data = np.ctypeslib.as_array(out, shape=(n.value * ch.value,)).copy()
    finally:
        _codecs().la_free(out)
    return data.reshape(n.value, ch.value).T, sr.value, (md5.raw if want_md5 else None)


def read_audio(path: str, return_md5: bool = False):
    """-> (pcm [C, S] float32, sr), by the file's extension; with
    `return_md5`, (pcm, sr, md5): a FLAC file's STREAMINFO MD5, else
    None."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        pcm, sr = read_wav(path)
        md5 = None
    elif ext == ".flac":
        pcm, sr, md5 = _decode(_codecs().la_read_flac, path, True)
    elif ext in (".mp3", ".ogg", ".oga"):
        lib = _codecs()
        pcm, sr, md5 = _decode(lib.la_read_mp3 if ext == ".mp3"
                               else lib.la_read_ogg, path, False)
    else:
        raise AudioReadError(f"unsupported audio format: {path}")
    return (pcm, sr, md5) if return_md5 else (pcm, sr)


def verify_flac_md5(path: str) -> bool:
    """Whether the decoded samples, as 16-bit integers, hash to the
    file's STREAMINFO MD5 (the format's own integrity check)."""
    pcm, _, md5 = read_audio(path, return_md5=True)
    ints = np.clip(np.round(pcm.T.reshape(-1) * 32768.0), -32768, 32767)
    return hashlib.md5(ints.astype("<i2").tobytes()).digest() == md5


def _mono_row(pcm) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(pcm, np.float32).reshape(-1))


def write_mp3(path: str, pcm: np.ndarray, sr: int, kbps: int = 64) -> None:
    """Encode mono float32 pcm to MP3 with the host's libmp3lame."""
    row = _mono_row(pcm)
    rc = _codecs().la_write_mp3(
        path.encode(), row.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(row), int(sr), int(kbps))
    if rc != 0:
        raise AudioReadError(f"mp3 encode failed rc={rc} (host lame missing?)")


def write_ogg(path: str, pcm: np.ndarray, sr: int, quality: float = 0.4) -> None:
    """Encode mono float32 pcm to Ogg/Vorbis with the host's libvorbis."""
    row = _mono_row(pcm)
    rc = _codecs().la_write_ogg(
        path.encode(), row.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(row), int(sr), ctypes.c_float(quality))
    if rc != 0:
        raise AudioReadError(f"ogg encode failed rc={rc} (host libvorbis missing?)")


def have_mp3() -> bool:
    """Whether the host's libmpg123 AND libmp3lame load: the callers
    (tests, the smoke run) write their MP3 files before they read them."""
    return bool(_codecs().la_have_mp3())


def have_ogg() -> bool:
    """Whether the host's Vorbis decode and encode libraries load."""
    return bool(_codecs().la_have_ogg())


# la_resample's filter: cutoff at 0.99 of the lower Nyquist rate, 24
# zero crossings each side, Kaiser beta 14.77 (~160 dB stopband)
ROLLOFF = 0.99
ZEROS = 24
KAISER_BETA = 14.77
# output samples formed per block of the vectorised loop (bounds memory)
_BLOCK = 1 << 14


def _bessel_i0(x: np.ndarray) -> np.ndarray:
    """la_resample's series for I0, element by element: terms are added
    until one falls below 1e-12 of the sum, at most 31 of them."""
    x = np.asarray(x, np.float64)
    total = np.ones_like(x)
    term = np.ones_like(x)
    live = np.ones(x.shape, bool)
    for k in range(1, 32):
        term = np.where(live, term * (x / (2.0 * k)) * (x / (2.0 * k)), term)
        total = np.where(live, total + term, total)
        live &= ~(term < 1e-12 * total)
        if not live.any():
            break
    return total


def _polyphase_filters(up: int, down: int) -> tuple[np.ndarray, int]:
    """[up, 2 * taps + 1] float64: phase p is the windowed sinc at input
    offsets t - p / up, t in [-taps, taps]."""
    fc = 0.5 * ROLLOFF * (up / down if up < down else 1.0)
    taps = math.ceil(ZEROS / (2.0 * fc))
    xt = (np.arange(-taps, taps + 1, dtype=np.float64)[None, :]
          - np.arange(up, dtype=np.float64)[:, None] / up)
    arg = xt / taps
    inside = np.abs(arg) <= 1.0
    w = np.where(inside, _bessel_i0(KAISER_BETA * np.sqrt(
        np.where(inside, 1.0 - arg * arg, 0.0))) / _bessel_i0(KAISER_BETA), 0.0)
    small = np.abs(xt) < 1e-12
    sinc = np.where(small, 2.0 * fc, np.sin(2.0 * np.pi * fc * xt)
                    / (np.pi * np.where(small, 1.0, xt)))
    return sinc * w, taps


def _resample_row(row: np.ndarray, fil: np.ndarray, taps: int, up: int,
                  down: int) -> np.ndarray:
    n = len(row)
    m = (n * up + down - 1) // down
    padded = np.concatenate([np.zeros(taps), row.astype(np.float64),
                             np.zeros(taps + 1)])
    out = np.empty(m, np.float32)
    offs = np.arange(2 * taps + 1)
    for j0 in range(0, m, _BLOCK):
        num = np.arange(j0, min(j0 + _BLOCK, m), dtype=np.int64) * down
        i0, phase = num // up, num % up
        # input i0 + t lies at padded[i0 + t + taps]; outside [0, n) it is 0
        win = padded[i0[:, None] + offs[None, :]]
        out[j0 : j0 + len(num)] = (win * fil[phase]).sum(axis=1)
    return out


def resample(pcm: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """[S] or [C, S] float32 -> resampled along the last axis, with
    ceil(S * sr_out / sr_in) samples a row."""
    if sr_in == sr_out:
        return pcm
    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    fil, taps = _polyphase_filters(up, down)
    x = np.asarray(pcm, np.float32)
    rows = x[None] if x.ndim == 1 else x
    y = np.stack([_resample_row(r, fil, taps, up, down) for r in rows])
    return y[0] if x.ndim == 1 else y
