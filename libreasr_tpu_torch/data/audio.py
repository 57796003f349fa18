"""Audio reading and resampling.

WAV (PCM16) is read with the stdlib `wave` module. `resample` is a
numpy copy of the JAX package's native resampler (native/audio.cpp,
`la_resample`): a rational polyphase Kaiser-windowed sinc with float64
taps and accumulation, so that both packages hear the same samples.
FLAC, Ogg/Vorbis and MP3 need the JAX package's native decoders, which
the port does not carry yet: reading them raises.
"""

from __future__ import annotations

import math
import os
import wave

import numpy as np


class AudioReadError(RuntimeError):
    pass


def read_wav(path: str):
    """-> (pcm [C, S] float32 in [-1, 1), sr)."""
    with wave.open(path, "rb") as w:
        ch = w.getnchannels()
        sr = w.getframerate()
        sw = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if sw != 2:
        raise AudioReadError(f"unsupported wav sample width {sw} in {path}")
    data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    return data.reshape(-1, ch).T.copy(), sr


def read_audio(path: str):
    """-> (pcm [C, S] float32, sr), by the file's extension."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        return read_wav(path)
    if ext in (".flac", ".ogg", ".oga", ".mp3"):
        raise AudioReadError(
            f"libreasr_tpu_torch: {ext} decoding is not ported yet (it needs "
            f"a copy of the native decoders); convert {path} to 16-bit WAV")
    raise AudioReadError(f"unsupported audio format: {path}")


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
