"""Batch audio conversion to 16 kHz mono PCM16 WAV (the JAX package's
scripts/convert.py).

    python -m libreasr_tpu_torch.scripts.convert <dir> [--sr 16000]

Walks <dir> and converts every .flac, .wav, .mp3, .ogg and .oga file
(skipping ones whose name holds ".16k.") to <stem>.<sr/1000>k.wav beside
it: the first channel, decoded by data/audio.py (FLAC in the port's C++
decoder, MP3 and Ogg through the host's codec libraries), resampled by
its polyphase sinc filter, rounded and clipped to int16.
"""

from __future__ import annotations

import argparse
import os
import wave

import numpy as np

from ..data.audio import read_audio, resample

SUFFIXES = (".flac", ".wav", ".mp3", ".ogg", ".oga")


def convert_file(path: str, sr: int) -> str:
    """`path` -> <stem>.<sr/1000>k.wav, mono at `sr`. Returns its path."""
    pcm, file_sr = read_audio(path)
    mono = pcm[0] if pcm.ndim == 2 else pcm
    if file_sr != sr:
        mono = resample(mono, file_sr, sr)
    out = os.path.splitext(path)[0] + f".{sr // 1000}k.wav"
    ints = np.clip(np.round(mono * 32767), -32768, 32767).astype(np.int16)
    with wave.open(out, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(ints.tobytes())
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("path")
    p.add_argument("--sr", type=int, default=16000)
    a = p.parse_args(argv)
    n = 0
    for root, _, files in os.walk(a.path):
        for f in files:
            if f.lower().endswith(SUFFIXES) and ".16k." not in f:
                out = convert_file(os.path.join(root, f), a.sr)
                n += 1
                if n % 100 == 0:
                    print(f"{n} converted (last: {out})")
    print(f"converted {n} files")
    return n


if __name__ == "__main__":
    main()
