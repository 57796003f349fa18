"""WAV reading with the stdlib `wave` module (PCM16)."""

from __future__ import annotations

import wave

import numpy as np


def read_wav(path: str):
    """-> (pcm [C, S] float32 in [-1, 1), sr)."""
    with wave.open(path, "rb") as w:
        ch = w.getnchannels()
        sr = w.getframerate()
        sw = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if sw != 2:
        raise ValueError(f"unsupported wav sample width {sw} in {path}")
    data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    return data.reshape(-1, ch).T.copy(), sr
