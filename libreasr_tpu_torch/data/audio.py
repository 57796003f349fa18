"""Audio reading and resampling.

WAV (PCM16) is read with the stdlib `wave` module; resampling is
scipy's polyphase `resample_poly`, the JAX package's own fallback when
its native library is absent. FLAC, Ogg/Vorbis and MP3 need the JAX
package's native decoders (native/audio.cpp), which the port does not
carry yet: reading them raises.
"""

from __future__ import annotations

import os
import wave
from math import gcd

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


def resample(pcm: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """[S] or [C, S] float32 -> resampled along the last axis."""
    if sr_in == sr_out:
        return pcm
    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    return resample_poly(np.asarray(pcm, np.float32), sr_out // g, sr_in // g,
                         axis=-1).astype(np.float32)
