"""The port's log-mel frontend against the JAX package's, float32 on
both sides, on the golden clips and on ragged random audio.

Tolerance: both compute the same DFT-matmul formulation in float32;
the two BLAS libraries sum the 1024-long products in different orders,
a relative difference of ~1e-6 in the mel energies, which the log turns
into an absolute one of the same size (measured: at most 8e-6 on these
inputs, whose log features span about -14 to 6). The bound is 1e-4."""

import os

import numpy as np
import pytest
import torch

from libreasr_tpu.data.audio import read_audio
from libreasr_tpu.ops import frontend as jfe
from libreasr_tpu_torch.data.audio import read_wav
from libreasr_tpu_torch.ops import frontend as tfe

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
ATOL = 1e-4


def _both(audio, lengths, conf=None):
    jcfg = jfe.FrontendConfig.from_config(conf or {})
    tcfg = tfe.FrontendConfig.from_config(conf or {})
    jf, jl = jfe.features_batch(np.asarray(audio), np.asarray(lengths), jcfg)
    tf, tl = tfe.features_batch(torch.from_numpy(np.asarray(audio)),
                                torch.from_numpy(np.asarray(lengths)), tcfg)
    return (np.asarray(jf), np.asarray(jl)), (tf.numpy(), tl.numpy())


def _golden_audio():
    audio = np.zeros((8, 16000), np.float32)
    for i in range(8):
        path = os.path.join(FIXTURES, f"s-{i:03d}.wav")
        pcm, sr = read_wav(path)
        ref, ref_sr = read_audio(path)
        assert sr == ref_sr == 16000
        np.testing.assert_array_equal(pcm, ref)
        audio[i] = pcm[0]
    return audio


def test_wav_reader_matches_and_features_on_golden():
    audio = _golden_audio()
    (jf, jl), (tf, tl) = _both(audio, np.full(8, 16000))
    assert tf.shape == jf.shape == (8, 12, 1280)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=ATOL)


@pytest.mark.parametrize("s,lengths", [
    (12000, [12000, 7000, 4001, 800]),
    (4000, [4000, 4000]),
])
def test_features_ragged_random(s, lengths):
    rng = np.random.default_rng(s)
    n = len(lengths)
    audio = (rng.standard_normal((n, s)) * 0.2).astype(np.float32)
    audio *= np.arange(s)[None, :] < np.asarray(lengths)[:, None]
    (jf, jl), (tf, tl) = _both(audio, np.asarray(lengths, np.int32))
    assert tf.shape == jf.shape
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=ATOL)


def test_int16_input_matches_float():
    rng = np.random.default_rng(1)
    pcm16 = rng.integers(-20000, 20000, (2, 8000)).astype(np.int16)
    lengths = np.array([8000, 5000])
    (jf, _), (tf, tl) = _both(pcm16, lengths)
    tf_float, _ = tfe.features_batch(
        torch.from_numpy(pcm16.astype(np.float32) / 32768.0),
        torch.from_numpy(lengths), tfe.FrontendConfig(),
    )
    np.testing.assert_array_equal(tf, tf_float.numpy())
    np.testing.assert_allclose(tf, jf, rtol=0, atol=ATOL)


def test_pieces_and_config():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 43, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tfe.stack_downsample(torch.from_numpy(x), n_stack=4, downsample=3).numpy(),
        np.asarray(jfe.stack_downsample(x, n_stack=4, downsample=3)),
    )
    c, s, fb = tfe.dft_mel_matrices(1024, 128, 16000, 400)
    jc, js, jfb = jfe.dft_mel_matrices(1024, 128, 16000, 400)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(fb, jfb)
    t = np.arange(0, 40)
    np.testing.assert_array_equal(
        tfe.stacked_length(torch.from_numpy(t)).numpy(),
        np.asarray(jfe.stacked_length(t)),
    )
    conf = {
        "sr": 8000, "melkwargs": {"n_fft": 512, "n_mels": 64},
        "transforms": {"features": [
            {"name": "LogMelSpectrogram"},
            {"name": "StackDownsample", "args": {"n_stack": 6, "downsample": 4}},
        ]},
    }
    tcfg, jcfg = tfe.FrontendConfig.from_config(conf), jfe.FrontendConfig.from_config(conf)
    for k in ("sr", "n_fft", "n_mels", "hop", "n_stack", "downsample", "feature_sz"):
        assert getattr(tcfg, k) == getattr(jcfg, k), k
    rng = np.random.default_rng(3)
    audio = (rng.standard_normal((2, 6000)) * 0.2).astype(np.float32)
    (jf, jl), (tf, tl) = _both(audio, np.array([6000, 3000]), conf)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=ATOL)
