"""The port's batch audio conversion (libreasr_tpu_torch/scripts/convert.py)
against the JAX package's scripts/convert.py: a 44.1 kHz stereo WAV and
an 8 kHz FLAC become the same 16 kHz mono WAV bytes, and the directory
walk converts both and skips a file already named .16k.wav."""

import os
import shutil
import sys
import wave

import numpy as np
import pytest

from helpers.flac_writer import write_flac
from libreasr_tpu_torch.scripts import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_wav(path, pcm, sr):
    ints = np.clip(np.round(pcm * 32767), -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(ints.shape[0])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(ints.T.tobytes())


@pytest.fixture
def tree(tmp_path):
    rng = np.random.default_rng(11)
    d = tmp_path / "audio" / "spk"
    d.mkdir(parents=True)
    t = np.arange(44100 * 3 // 2) / 44100
    stereo = np.stack([0.4 * np.sin(2 * np.pi * 440 * t),
                       rng.standard_normal(t.size) * 0.1]).clip(-1, 1)
    _write_wav(str(d / "a.wav"), stereo, 44100)
    write_flac(str(d / "b.flac"),
               np.round(rng.standard_normal(8000 * 2) * 4000).astype(np.int64),
               8000, method="fixed2")
    _write_wav(str(d / "c.16k.wav"), rng.standard_normal((1, 1600)) * 0.1, 16000)
    return tmp_path / "audio"


def _jax_convert():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from scripts import convert as jax_convert

    return jax_convert


@pytest.mark.parametrize("name", ["a.wav", "b.flac"])
def test_convert_file_bytes_equal_jax(tree, tmp_path, name):
    ref_dir = tmp_path / "ref"
    shutil.copytree(tree, ref_dir)
    out = convert.convert_file(str(tree / "spk" / name), 16000)
    ref = _jax_convert().convert_file(str(ref_dir / "spk" / name), 16000)
    assert out == os.path.splitext(str(tree / "spk" / name))[0] + ".16k.wav"
    with open(out, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    with wave.open(out) as w:
        assert (w.getnchannels(), w.getframerate()) == (1, 16000)


def test_main_walks_and_skips_converted(tree, capsys):
    skipped = (tree / "spk" / "c.16k.wav").read_bytes()
    assert convert.main([str(tree)]) == 2
    assert "converted 2 files" in capsys.readouterr().out
    assert sorted(os.listdir(tree / "spk")) == [
        "a.16k.wav", "a.wav", "b.16k.wav", "b.flac", "c.16k.wav"]
    assert (tree / "spk" / "c.16k.wav").read_bytes() == skipped
