"""Seeded speech-like audio for the stream cells.

Words are tone speech: a copy of the port's tone renderer
(`libreasr_tpu_torch/data/synth.py:render`), rewritten here so that the
yardstick does not move with the program. Every character is a harmonic
tone of its own frequency, a space is silence.

An utterance is words separated by pauses, padded with a noise floor to
a whole number of engine steps. Its length, and the pauses inside it,
come from the distributions the traffic file states. PCM is rounded to
16-bit levels, as a capture chain delivers it, so that the engine's
int16 wire codec and its float32 one carry the same samples.

An utterance is kept as a small spec (word ids, pauses, noise offsets)
and rendered when a slot needs it, so that the check can render the
same audio again after the window.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SR = 16000
CHAR_MS = 70
RAMP_MS = 5
NOISE_AMP = 0.02

WORDS = (
    "the a and to of in it is was for on that he she they we you i "
    "his her with as at by this had not but be have from or one all "
    "were when there can an which their said if do will each about "
    "how up out them then she many some so these would other into "
    "has more two like him see time could no make than first been "
    "its who now people my made over did down only way find use may "
    "water long little very after words called just where most know"
).split()


def char_freq(c: str) -> float:
    return 300.0 + 85.0 * (ord(c) - ord("a"))


def render_word(word: str, rng: np.random.Generator) -> np.ndarray:
    """One word as tone speech, single clean voice, without noise (the
    utterance adds its noise floor once)."""
    tempo = 1.0 + rng.uniform(-0.05, 0.05)
    ramp = int(SR * RAMP_MS / 1000)
    n_char = max(int(SR * CHAR_MS / 1000 / tempo), 4 * ramp)
    env = np.ones(n_char, np.float32)
    env[:ramp] = np.linspace(0, 1, ramp)
    env[-ramp:] = np.linspace(1, 0, ramp)
    t = np.arange(n_char) / SR
    segs = []
    for c in word:
        amp = 0.25 + 0.1 * rng.random()
        tone = np.sin(2 * np.pi * char_freq(c) * t)
        segs.append((amp * tone * env).astype(np.float32))
    return np.concatenate(segs)


@dataclass(frozen=True)
class UttSpec:
    """One utterance: `samples` long, words at `starts` (sample offsets),
    the noise floor read from the bank at `noise_off`."""
    samples: int
    words: tuple
    starts: tuple
    noise_off: int


class AudioBank:
    """Rendered words and a noise floor, made once per run from the seed;
    utterances are cut from them."""

    def __init__(self, seed: int, noise_seconds: float = 20.0):
        rng = np.random.default_rng([seed, 7])
        self.words = [to_int16_levels(render_word(w, rng)) for w in WORDS]
        self.noise = to_int16_levels(rng.standard_normal(
            int(noise_seconds * SR)) * NOISE_AMP)

    def render(self, spec: UttSpec) -> np.ndarray:
        """The utterance's PCM, float32 on 16-bit levels: the words and
        the noise floor are on them, and their sums stay exact (no sum
        reaches full scale)."""
        n = spec.samples
        pcm = np.empty(n, np.float32)
        off, left, pos = spec.noise_off, n, 0
        while left:  # the noise floor, wrapped around the bank
            k = min(left, len(self.noise) - off)
            pcm[pos:pos + k] = self.noise[off:off + k]
            pos, left, off = pos + k, left - k, 0
        for w, s in zip(spec.words, spec.starts):
            clip = self.words[w][: n - s]
            pcm[s:s + len(clip)] += clip
        return pcm


def to_int16_levels(pcm: np.ndarray) -> np.ndarray:
    """Round to the levels of 16-bit PCM: x * 32768 is then an exact
    int16, so both wire codecs of the engine carry these samples."""
    q = np.clip(np.round(pcm * 32768.0), -32768, 32767)
    return (q / 32768.0).astype(np.float32)


def utterance(rng: np.random.Generator, bank: AudioBank, samples: int,
              pause_s: tuple) -> UttSpec:
    """Words with pauses drawn uniform in `pause_s` (seconds) between
    them, filling `samples`; the rest is noise floor."""
    words, starts = [], []
    pos = int(rng.uniform(*pause_s) * SR)
    while True:
        w = int(rng.integers(len(WORDS)))
        if pos + len(bank.words[w]) > samples:
            break
        words.append(w)
        starts.append(pos)
        pos += len(bank.words[w]) + int(rng.uniform(*pause_s) * SR)
    off = int(rng.integers(len(bank.noise)))
    return UttSpec(samples, tuple(words), tuple(starts), off)


def length_pool(n: int, lo_steps: int, hi_steps: int) -> np.ndarray:
    """`n` utterance lengths in engine steps, uniform over
    [lo_steps, hi_steps], from a fixed generator: every seed plays the
    same lengths, in its own order, so that the seed changes the audio
    and not the amount of work."""
    return np.random.default_rng(12345).integers(lo_steps, hi_steps + 1, n)
