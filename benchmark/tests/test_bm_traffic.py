"""The traffic is a function of the seed: the same seed gives the same
audio, another seed other audio, and every seed the same lengths."""

import numpy as np

from benchmark import audio as A


def _utts(seed, n=6):
    bank = A.AudioBank(seed)
    rng = np.random.default_rng([seed, 2])
    specs = [A.utterance(rng, bank, 1280 * k, (0.2, 2.0)) for k in (25, 60, 100, 187, 30, 90)[:n]]
    return bank, specs


def test_same_seed_same_audio():
    b1, s1 = _utts(2**31 + 3)
    b2, s2 = _utts(2**31 + 3)
    assert s1 == s2
    for a, b in zip(s1, s2):
        assert np.array_equal(b1.render(a), b2.render(b))


def test_other_seed_other_audio():
    b1, s1 = _utts(11)
    b2, s2 = _utts(12)
    assert s1 != s2
    assert not np.array_equal(b1.render(s1[3]), b2.render(s2[3]))


def test_audio_is_on_16_bit_levels_and_has_pauses():
    bank, specs = _utts(5)
    pcm = bank.render(specs[3])
    assert len(pcm) == specs[3].samples
    assert np.array_equal(np.round(pcm * 32768.0), pcm * 32768.0)
    gaps = np.diff(specs[3].starts)
    assert len(gaps) >= 2 and gaps.max() > 0.2 * A.SR


def test_every_seed_plays_the_same_lengths():
    pool = A.length_pool(1000, 25, 187)
    perm = [pool[np.random.default_rng([s, 1]).permutation(1000)] for s in (1, 2)]
    assert not np.array_equal(perm[0], perm[1])
    assert np.array_equal(np.sort(perm[0]), np.sort(perm[1]))
    assert pool.min() >= 25 and pool.max() <= 187
