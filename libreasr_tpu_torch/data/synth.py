"""Streamed synthetic "tone speech": an endless training corpus (the JAX
package's data/synth.py, the same numpy arithmetic, so the same seed
gives the same texts, speakers, pcm and ids bit for bit).

Each character is a frequency-coded harmonic tone and a space is
silence; each speaker has its own f0 scale, harmonic stack and speaking
rate; each utterance its own tempo jitter and additive noise at 12-30 dB
SNR. Train epoch k draws its sentences from rng [seed, 1, k] and its
speakers and noise from [seed, 2, k]; the dev and test sets are fixed,
spoken by held-out speakers, and their sentences are never trained on.

A config with

    synth_tone:
      enabled: true
      hours_per_epoch: 0.5
      speakers: 16
      heldout_speakers: 4
      eval_utts: 96

makes ASRDataset.from_config return a ToneStreamDataset, whose batches
are the port's training.learner.Batch through its BucketBatcher.
"""

from __future__ import annotations

import numpy as np

SR = 16000
CHAR_MS = 70
RAMP_MS = 5

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
    """Distinct frequency per letter; well inside the mel range."""
    return 300.0 + 85.0 * (ord(c) - ord("a"))


def speaker_params(spk: int) -> dict:
    """Deterministic per-speaker "voice": f0 scale (vocal tract length
    analog, ±3% — adjacent letters are ~3.6% apart at the top of the
    range, so speakers overlap there and decoding must normalize),
    harmonic amplitudes (formant analog) and speaking rate."""
    r = np.random.default_rng(1000 + spk)
    return {
        "f0_scale": float(1.0 + r.uniform(-0.03, 0.03)),
        "h2": float(r.uniform(0.1, 0.5)),   # 2nd harmonic amplitude
        "h3": float(r.uniform(0.0, 0.3)),   # 3rd harmonic amplitude
        "rate": float(r.uniform(0.9, 1.1)),  # speaking rate
    }


def render(
    text: str,
    rng: np.random.Generator,
    spk: dict | None = None,
    snr_db: float | None = None,
) -> np.ndarray:
    """Render text as tone speech. spk=None keeps the single-voice
    clean synthesis (bench workloads use this); with a speaker dict the
    voice/rate/noise axes apply."""
    if spk is None:
        spk = {"f0_scale": 1.0, "h2": 0.0, "h3": 0.0, "rate": 1.0}
    tempo = spk["rate"] * (1.0 + rng.uniform(-0.05, 0.05))
    n_char = max(int(SR * CHAR_MS / 1000 / tempo), 4 * int(SR * RAMP_MS / 1000))
    ramp = int(SR * RAMP_MS / 1000)
    env = np.ones(n_char, np.float32)
    env[:ramp] = np.linspace(0, 1, ramp)
    env[-ramp:] = np.linspace(1, 0, ramp)
    t = np.arange(n_char) / SR
    segs = []
    for c in text:
        if c == " ":
            segs.append(np.zeros(n_char, np.float32))
        else:
            amp = 0.25 + 0.1 * rng.random()
            f0 = char_freq(c) * spk["f0_scale"]
            tone = np.sin(2 * np.pi * f0 * t)
            if spk["h2"]:
                tone = tone + spk["h2"] * np.sin(2 * np.pi * 2 * f0 * t)
            if spk["h3"]:
                tone = tone + spk["h3"] * np.sin(2 * np.pi * 3 * f0 * t)
            tone = tone / (1.0 + spk["h2"] + spk["h3"])
            segs.append((amp * tone * env).astype(np.float32))
    pcm = np.concatenate(segs) if segs else np.zeros(n_char, np.float32)
    if snr_db is None:
        noise_amp = 0.02
    else:
        sig_rms = float(np.sqrt(np.mean(pcm**2)) + 1e-9)
        noise_amp = sig_rms / (10.0 ** (snr_db / 20.0))
    pcm = pcm + (rng.standard_normal(len(pcm)) * noise_amp).astype(np.float32)
    return np.clip(pcm, -1.0, 1.0)


def sentence(rng: np.random.Generator, min_words: int = 2,
             max_words: int = 8, max_chars: int = 58) -> str:
    k = int(rng.integers(min_words, max_words))
    words = [WORDS[int(rng.integers(len(WORDS)))] for _ in range(k)]
    return " ".join(words)[:max_chars].strip()


def sentences(rng: np.random.Generator, n: int, max_chars: int = 58,
              reject: set | None = None) -> list[str]:
    out: list[str] = []
    seen: set = set() if reject is None else set(reject)
    while len(out) < n:
        s = sentence(rng, max_chars=max_chars)
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


class _BuilderShim:
    """Just enough of ASRDatasetBuilder's face for train.py's prints."""

    def __init__(self, n: int, hours: float, desc: str):
        self._n, self._hours, self._desc = n, hours, desc

    def __len__(self) -> int:
        return self._n

    def stats(self) -> str:
        return f"{self._desc}: ~{self._n} utts/epoch, {self._hours:.2f} h"


class ToneStreamDataset:
    """ASRDataset-compatible iterable over streamed tone speech.

    mode="train": each __iter__ call is one epoch of `hours_per_epoch`
    freshly generated audio (epoch k: sentences from rng [seed, 1, k],
    speakers/noise from rng [seed, 2, k]); sentences in the reserved
    dev/test set are rejected, so the model NEVER trains on an eval
    sentence or an eval voice.

    mode="valid"/"test": a deterministic fixed set on held-out
    speakers — identical batches every epoch (eval comparability).
    """

    def __init__(self, lang, batcher, *, mode: str, hours_per_epoch: float,
                 speakers: int, heldout_speakers: int, eval_utts: int,
                 seed: int, num_workers: int = 4, prefetch: int = 64,
                 snr_range=(12.0, 30.0)):
        self.lang = lang
        self.batcher = batcher
        self.mode = mode
        self.hours_per_epoch = hours_per_epoch
        self.train_speakers = list(range(1, speakers + 1))
        self.held_speakers = list(
            range(speakers + 1, speakers + 1 + heldout_speakers)
        )
        self.eval_utts = eval_utts
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.snr_range = snr_range
        self.epoch = 0  # advanced by __iter__ in train mode

        # the reserved eval sentence sets are a pure function of the
        # seed, shared by every split instance (train rejects them)
        r = np.random.default_rng([seed, 0])
        self._dev_sents = sentences(r, eval_utts)
        self._test_sents = sentences(r, eval_utts, reject=set(self._dev_sents))
        self._reserved = set(self._dev_sents) | set(self._test_sents)

        n_epoch = self._utts_per_epoch()
        hours = (eval_utts if mode != "train" else n_epoch) * \
            self._mean_secs() / 3600.0
        self.builder = _BuilderShim(
            eval_utts if mode != "train" else n_epoch, hours,
            f"tone-stream/{mode}",
        )

    # -- sizing ------------------------------------------------------------

    def _mean_secs(self) -> float:
        # mean sentence ~23 chars incl. spaces at CHAR_MS per char
        return 23 * CHAR_MS / 1000.0

    def _utts_per_epoch(self) -> int:
        return max(int(self.hours_per_epoch * 3600.0 / self._mean_secs()), 1)

    # -- item generation ----------------------------------------------------

    def _make_item(self, text: str, spk_id: int, item_seed) -> dict:
        r = np.random.default_rng(item_seed)
        snr = float(r.uniform(*self.snr_range))
        pcm = render(text, r, spk=speaker_params(spk_id), snr_db=snr)
        return {
            "audio": pcm,
            "ids": self.lang.numericalize(text),
            "text": text,
            "speaker": spk_id,
        }

    def _epoch_specs(self, epoch: int):
        """[(text, speaker, item_seed)] for one pass."""
        if self.mode == "train":
            r = np.random.default_rng([self.seed, 1, epoch])
            texts = sentences(r, self._utts_per_epoch(),
                              reject=self._reserved)
            spk = self.train_speakers
            salt = 100 + epoch
        else:
            texts = (self._dev_sents if self.mode == "valid"
                     else self._test_sents)
            spk = self.held_speakers or self.train_speakers
            salt = 2 if self.mode == "valid" else 3
        return [
            (t, spk[i % len(spk)], [self.seed, salt, i])
            for i, t in enumerate(texts)
        ]

    def _items(self, specs):
        if self.num_workers <= 1:
            for t, s, sd in specs:
                yield self._make_item(t, s, sd)
            return
        import concurrent.futures as cf
        from collections import deque

        with cf.ThreadPoolExecutor(self.num_workers) as ex:
            pending: deque = deque()
            idx = 0
            while idx < len(specs) or pending:
                while idx < len(specs) and len(pending) < self.prefetch:
                    pending.append(ex.submit(self._make_item, *specs[idx]))
                    idx += 1
                yield pending.popleft().result()

    def __iter__(self):
        specs = self._epoch_specs(self.epoch)
        if self.mode == "train":
            self.epoch += 1  # next pass = fresh sentences
        return self.batcher.batches(self._items(specs))

    # -- config ------------------------------------------------------------

    @classmethod
    def from_config(cls, conf: dict, lang, mode: str = "train"):
        from .batching import BucketBatcher, buckets_from_config

        sc = conf.get("synth_tone") or {}
        batcher = BucketBatcher(
            buckets_from_config(conf),
            shuffle=False,  # the stream is already i.i.d.
            seed=conf.get("seed", 42),
            drop_last=bool(conf.get("drop_last", False)) and mode == "train",
            transfer_dtype=conf.get("transfer_dtype", "int16"),
        )
        return cls(
            lang, batcher,
            mode=mode,
            hours_per_epoch=float(sc.get("hours_per_epoch", 0.5)),
            speakers=int(sc.get("speakers", 16)),
            heldout_speakers=int(sc.get("heldout_speakers", 4)),
            eval_utts=int(sc.get("eval_utts", 96)),
            seed=int(sc.get("seed", conf.get("seed", 42))),
            num_workers=int(conf.get("num_workers", 4) or 4),
            snr_range=tuple(sc.get("snr_db", (12.0, 30.0))),
        )

    # -- bucket derivation (recipes) ----------------------------------------

    def sample_lengths(self, n: int = 512):
        """(xlen_ms, ylen_tokens) arrays from n generated items — feeds
        buckets_from_histogram without materializing a corpus."""
        r = np.random.default_rng([self.seed, 4])
        texts = sentences(r, n)
        xl, yl = [], []
        for i, t in enumerate(texts):
            it = self._make_item(t, self.train_speakers[i % len(self.train_speakers)],
                                 [self.seed, 5, i])
            xl.append(len(it["audio"]) / SR * 1000.0)
            yl.append(len(it["ids"]))
        return np.asarray(xl), np.asarray(yl)
