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


def _jax_draws(key, n, t, cfg):
    """The integers JAX's features_batch(augment=True) draws from `key`."""
    import jax

    k1, k2, k3 = jax.random.split(key, 3)
    kf, kb = jax.random.split(k1)
    return tfe.AugmentDraws(*(torch.tensor(np.asarray(a)).long() for a in (
        jax.random.randint(kf, (n,), 0, cfg.cut_max_front + 1),
        jax.random.randint(kb, (n,), 0, cfg.cut_max_back + 1),
        jax.random.randint(k2, (n, cfg.time_masks), 0,
                           max(t - cfg.time_mask_size, 1)),
        jax.random.randint(k3, (n, cfg.freq_masks), 0,
                           max(cfg.n_mels - cfg.freq_mask_size, 1)),
    )))


AUG_CONFS = [
    {},
    {"transforms": {"features": [
        {"name": "LogMelSpectrogram"},
        {"name": "CutFrames", "args": {"max_front": 3, "max_back": 2}},
        {"name": "MaskTime", "args": {"num_masks": 2, "size": 5}},
        {"name": "MaskFreq", "args": {"num_masks": 3, "size": 7}},
        {"name": "StackDownsample", "args": {"n_stack": 10, "downsample": 8}},
    ]}},
]


@pytest.mark.parametrize("conf", AUG_CONFS, ids=["defaults", "custom"])
def test_spec_augment_with_jax_draws_matches(conf):
    """JAX's draws applied by the port: the same frames cut, the same
    time and frequency bands filled with each row's mean, the same
    lengths. Tolerance ATOL, the frontend's own (DFT summation order)."""
    import jax

    rng = np.random.default_rng(7)
    audio = (rng.standard_normal((3, 9000)) * 0.2).astype(np.float32)
    lengths = np.array([9000, 6000, 2500])
    audio *= np.arange(9000)[None, :] < lengths[:, None]
    jcfg = jfe.FrontendConfig.from_config(conf)
    tcfg = tfe.FrontendConfig.from_config(conf)
    for k in ("cut_max_front", "cut_max_back", "time_masks", "time_mask_size",
              "freq_masks", "freq_mask_size"):
        assert getattr(tcfg, k) == getattr(jcfg, k), k
    key = jax.random.PRNGKey(11)
    jf, jl = jfe.features_batch(audio, lengths, jcfg, rng=key, augment=True)
    t_mel = int(jfe.num_frames(9000, jcfg.hop))
    draws = _jax_draws(key, 3, t_mel, tcfg)
    tf, tl = tfe.features_batch(torch.from_numpy(audio), torch.from_numpy(lengths),
                                tcfg, augment=True, draws=draws)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=ATOL)
    plain, _ = tfe.features_batch(torch.from_numpy(audio), torch.from_numpy(lengths),
                                  tcfg)
    assert not np.allclose(plain.numpy(), tf.numpy())


def test_spec_augment_pieces_and_draws():
    """cut_frames, mask_time and mask_freq equal JAX's on the same
    integers (the fill is a float32 mean, summed in another order: 1e-6);
    the port's own draws stay in JAX's ranges."""
    import jax.numpy as jnp

    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 30, 16)).astype(np.float32)
    lengths = np.array([30, 20, 3, 1])
    front, back = np.array([0, 1, 2, 1]), np.array([1, 0, 2, 1])
    starts_t = rng.integers(0, 28, (4, 3))
    starts_f = rng.integers(0, 12, (4, 2))
    tx, tl = tfe.cut_frames(torch.from_numpy(x), torch.from_numpy(lengths),
                            torch.from_numpy(front), torch.from_numpy(back))
    t_idx = (np.arange(30)[None, :] + front[:, None]) % 30
    jx = np.take_along_axis(x, t_idx[:, :, None], axis=1)
    np.testing.assert_array_equal(tx.numpy(), jx)
    np.testing.assert_array_equal(tl.numpy(), np.maximum(lengths - front - back, 1))
    for fn, jfn, starts, size, axis in (
            (tfe.mask_time, jfe._mask_axis, starts_t, 2, 1),
            (tfe.mask_freq, jfe._mask_axis, starts_f, 4, 2)):
        got = fn(torch.from_numpy(x), torch.from_numpy(starts), size).numpy()
        pos = np.arange(x.shape[axis])
        hit = ((pos[None, None] >= starts[:, :, None])
               & (pos[None, None] < starts[:, :, None] + size)).any(1)
        shape = [4, 1, 1]
        shape[axis] = x.shape[axis]
        want = np.where(hit.reshape(shape), np.asarray(jnp.mean(x, axis=(1, 2),
                                                                keepdims=True)), x)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    cfg = tfe.FrontendConfig()
    d = cfg.draw_augment(64, 50, torch.Generator().manual_seed(0))
    assert d.front.max() <= 1 and d.back.max() <= 1 and d.front.min() >= 0
    assert d.time.shape == (64, 4) and 0 <= d.time.min() and d.time.max() < 48
    assert d.freq.shape == (64, 4) and d.freq.max() < 124
    off = tfe.FrontendConfig(cut_max_front=0, cut_max_back=0, time_masks=0,
                             freq_masks=0)
    assert off.draw_augment(2, 50, torch.Generator()) == (None, None, None, None)
