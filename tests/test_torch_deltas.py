"""Delta features in the port's frontend against the JAX package's.

`compute_deltas` on random frames, and `features_batch` with deltas 1
and 2 (the delta orders concatenated after the log-mel frames, before
SpecAugment and stacking), with and without SpecAugment on JAX's draws.

Tolerances: compute_deltas takes the same float32 sums in the same
order on both sides (1e-6 absolute on inputs of unit size). The
features: the log-mel frames differ by at most 8e-6 (the frontend's own
bound, tests/test_torch_frontend.py: the DFT's summation order); a delta
of window 3 is (x[t+1] - x[t-1]) / 2 and of window 5 a sum of four
differences over 10, so each order at most doubles that difference:
1e-4 at order 1 (the frontend's ATOL), 2e-4 at order 2.
"""

import numpy as np
import pytest
import torch

from libreasr_tpu.ops import frontend as jfe
from libreasr_tpu_torch.ops import frontend as tfe


@pytest.mark.parametrize("win", [3, 5])
@pytest.mark.parametrize("shape", [(2, 17, 6), (9, 4), (1, 1, 3)])
def test_compute_deltas_matches_jax(win, shape):
    x = np.random.default_rng(win).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jfe.compute_deltas(x, win))
    out = tfe.compute_deltas(torch.from_numpy(x), win).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def _conf(deltas, win=3, augment=False):
    conf = {"deltas": deltas, "delta_win_length": win}
    if augment:
        conf["transforms"] = {"features": [
            {"name": "LogMelSpectrogram"},
            {"name": "CutFrames", "args": {"max_front": 2, "max_back": 1}},
            {"name": "MaskTime", "args": {"num_masks": 2, "size": 3}},
            {"name": "MaskFreq", "args": {"num_masks": 3, "size": 9}},
            {"name": "StackDownsample", "args": {"n_stack": 10, "downsample": 8}},
        ]}
    return conf


def _audio(seed):
    rng = np.random.default_rng(seed)
    lengths = np.array([9000, 6100, 2500])
    audio = (rng.standard_normal((3, 9000)) * 0.2).astype(np.float32)
    audio *= np.arange(9000)[None, :] < lengths[:, None]
    return audio, lengths


@pytest.mark.parametrize("deltas,win,tol", [(1, 3, 1e-4), (2, 3, 2e-4),
                                            (1, 5, 1e-4)])
def test_features_batch_with_deltas_matches_jax(deltas, win, tol):
    conf = _conf(deltas, win)
    jcfg, tcfg = jfe.FrontendConfig.from_config(conf), tfe.FrontendConfig.from_config(conf)
    assert tcfg.feature_sz == jcfg.feature_sz == 128 * (1 + deltas) * 10
    audio, lengths = _audio(deltas)
    jf, jl = jfe.features_batch(audio, lengths, jcfg)
    tf, tl = tfe.features_batch(torch.from_numpy(audio), torch.from_numpy(lengths), tcfg)
    assert tf.shape[-1] == tcfg.feature_sz and tf.shape == np.asarray(jf).shape
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=tol)


def test_spec_augment_on_delta_features_with_jax_draws():
    """SpecAugment runs after the deltas: JAX's draws applied by the port
    give the same features; frequency masks reach into the delta block
    (their range is n_mels * (1 + deltas))."""
    import jax

    conf = _conf(1, augment=True)
    jcfg, tcfg = jfe.FrontendConfig.from_config(conf), tfe.FrontendConfig.from_config(conf)
    audio, lengths = _audio(5)
    key = jax.random.PRNGKey(3)
    jf, jl = jfe.features_batch(audio, lengths, jcfg, rng=key, augment=True)
    t_mel = int(jfe.num_frames(9000, jcfg.hop))
    k1, k2, k3 = jax.random.split(key, 3)
    kf, kb = jax.random.split(k1)
    draws = tfe.AugmentDraws(*(torch.tensor(np.asarray(a)).long() for a in (
        jax.random.randint(kf, (3,), 0, tcfg.cut_max_front + 1),
        jax.random.randint(kb, (3,), 0, tcfg.cut_max_back + 1),
        jax.random.randint(k2, (3, tcfg.time_masks), 0,
                           max(t_mel - tcfg.time_mask_size, 1)),
        jax.random.randint(k3, (3, tcfg.freq_masks), 0,
                           max(256 - tcfg.freq_mask_size, 1)),
    )))
    tf, tl = tfe.features_batch(torch.from_numpy(audio), torch.from_numpy(lengths),
                                tcfg, augment=True, draws=draws)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-4)
    own = tcfg.draw_augment(64, t_mel, torch.Generator().manual_seed(0))
    assert int(own.freq.max()) >= 128  # the delta block is masked too
    assert int(own.freq.max()) < 256 - tcfg.freq_mask_size
