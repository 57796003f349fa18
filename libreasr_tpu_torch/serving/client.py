"""Test client (the JAX package's serving/client.py): reads an audio
file and calls both RPCs of a live server.

Usage: python -m libreasr_tpu_torch.serving.client clip.wav [--port 50051]

The port reads WAV only until its FLAC/Ogg/MP3 decoders are ported.
"""

from __future__ import annotations

import argparse

import numpy as np

from . import proto

CHUNK_S = 0.08  # 80 ms wire chunks


def grab_audio(path: str, sr: int = 16000):
    from ..data.audio import read_audio, resample

    pcm, file_sr = read_audio(path)
    pcm = pcm[0]
    if file_sr != sr:
        pcm = resample(pcm, file_sr, sr)
    return pcm.astype(np.float32), sr


def grab_audio_stream(path: str, sr: int = 16000, n_pad: int = 2):
    """80 ms chunks with zero-padded lead-in and lead-out."""
    pcm, sr = grab_audio(path, sr)
    chunk = int(CHUNK_S * sr)
    zeros = np.zeros(chunk, np.float32)
    for _ in range(n_pad):
        yield proto.Audio(data=zeros.tobytes(), sr=sr)
    for i in range(0, len(pcm), chunk):
        buf = pcm[i : i + chunk]
        if len(buf) < chunk:
            buf = np.pad(buf, (0, chunk - len(buf)))
        yield proto.Audio(data=buf.tobytes(), sr=sr)
    for _ in range(n_pad):
        yield proto.Audio(data=zeros.tobytes(), sr=sr)


def test_asr(path: str, host: str = "localhost", port: int = 50051):
    """Both RPCs on one file. Returns (unary text, streamed text)."""
    import grpc

    channel = grpc.insecure_channel(f"{host}:{port}")
    unary = channel.unary_unary(
        proto.METHOD_TRANSCRIBE,
        request_serializer=proto.Audio.SerializeToString,
        response_deserializer=proto.Transcript.FromString,
    )
    stream = channel.stream_stream(
        proto.METHOD_TRANSCRIBE_STREAM,
        request_serializer=proto.Audio.SerializeToString,
        response_deserializer=proto.Transcript.FromString,
    )

    pcm, sr = grab_audio(path)
    print("Transcribe...")
    out = unary(proto.Audio(data=pcm.tobytes(), sr=sr))
    print("  ->", repr(out.data))

    print("TranscribeStream...")
    pieces = [t.data for t in stream(grab_audio_stream(path))]
    print("  ->", repr("".join(pieces)))
    channel.close()
    return out.data, "".join(pieces)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("path", help="a WAV file")
    p.add_argument("--host", default="localhost")
    p.add_argument("--port", type=int, default=50051)
    a = p.parse_args(argv)
    test_asr(a.path, a.host, a.port)


if __name__ == "__main__":
    main()
