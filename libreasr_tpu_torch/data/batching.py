"""Bucketed batching: variable-length utterances -> a few fixed shapes
(the JAX package's data/batching.py).

Each batch snaps to a bucket (max_samples, max_tokens, bs) of the
config's ladder: an item goes to the smallest bucket that holds its
audio and its tokens; within a window of items, shuffled then sorted by
length, a bucket emits a batch when it holds bs items; leftovers are
emitted at the end in power-of-two sub-batches (a batch of one is
dropped: batch norm needs two rows). Batches are the port's
training.learner.Batch of CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from ..training.learner import Batch


@dataclass(frozen=True)
class Bucket:
    max_samples: int   # padded audio samples
    max_tokens: int    # padded label length
    bs: int

    @property
    def key(self):
        return (self.max_samples, self.max_tokens, self.bs)


def buckets_from_config(conf: dict) -> list[Bucket]:
    """Config buckets give x_max in mel frames (or max_samples); without
    buckets, one of almaxs seconds, y_max + 2 tokens and bs rows."""
    sr = conf.get("sr", 16000)
    hop = int(conf.get("hop_length", 0.01) * sr)
    out = []
    for b in conf.get("buckets", []) or []:
        samples = int(b["max_samples"]) if "max_samples" in b else int(b["x_max"]) * hop
        out.append(Bucket(samples, int(b["y_max"]), int(b["bs"])))
    if not out:
        out = [Bucket(int(conf.get("almaxs", 6.0) * sr),
                      conf.get("y_max", 60) + 2, conf.get("bs", 8))]
    return sorted(out, key=lambda b: b.max_samples)


def pick_bucket(buckets: list[Bucket], n_samples: int, n_tokens: int):
    for b in buckets:
        if n_samples <= b.max_samples and n_tokens <= b.max_tokens:
            return b
    return None  # too long: dropped


class BucketBatcher:
    """Groups pipeline items (dicts with `audio` [S] float32 and `ids`)
    into fixed-shape Batches; the window's shuffle draws from a numpy
    Generator seeded as the JAX package's."""

    def __init__(self, buckets: list[Bucket], *, shuffle: bool = True,
                 seed: int = 42, window: int = 1024, drop_last: bool = False,
                 transfer_dtype: str = "float32"):
        if transfer_dtype not in ("float32", "int16"):
            raise ValueError(f"transfer_dtype must be float32|int16, "
                             f"got {transfer_dtype!r}")
        self.buckets = buckets
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.window = window
        self.drop_last = drop_last
        self.transfer_dtype = transfer_dtype

    def _emit(self, bucket: Bucket, items: list[dict]) -> Batch:
        n = len(items)
        int16 = self.transfer_dtype == "int16"
        audio = np.zeros((n, bucket.max_samples), np.int16 if int16 else np.float32)
        audio_len = np.zeros(n, np.int32)
        labels = np.zeros((n, bucket.max_tokens), np.int32)
        label_len = np.zeros(n, np.int32)
        for i, it in enumerate(items):
            a = np.asarray(it["audio"], np.float32)[: bucket.max_samples]
            if int16:  # exact inverse of the frontend's x / 32768
                a = np.clip(np.round(a * 32768.0), -32768, 32767)
            audio[i, : len(a)] = a
            audio_len[i] = len(a)
            ids = list(it["ids"])[: bucket.max_tokens]
            labels[i, : len(ids)] = ids
            label_len[i] = len(ids)
        return Batch(*(torch.from_numpy(x)
                       for x in (audio, audio_len, labels, label_len)))

    def batches(self, items) -> Iterator[Batch]:
        pending = {b.key: [] for b in self.buckets}
        window: list[dict] = []

        def flush_window():
            w = window.copy()
            window.clear()
            if self.shuffle:
                self.rng.shuffle(w)
            w.sort(key=lambda it: len(it["audio"]))
            for it in w:
                b = pick_bucket(self.buckets, len(it["audio"]), len(it["ids"]))
                if b is None:
                    continue
                pending[b.key].append(it)
                if len(pending[b.key]) == b.bs:
                    yield self._emit(b, pending[b.key])
                    pending[b.key] = []

        for it in items:
            window.append(it)
            if len(window) >= self.window:
                yield from flush_window()
        yield from flush_window()
        if not self.drop_last:
            for b in self.buckets:
                rest = pending[b.key]
                while len(rest) > 1:
                    k = 1 << (len(rest).bit_length() - 1)
                    yield self._emit(b, rest[:k])
                    rest = rest[k:]


class ASRDataset:
    """Builder + pipeline + batcher: an iterable of Batches, one pass of
    the builder's rows per iteration (an epoch). With num_workers > 1 the
    pipeline runs in a thread pool; each item draws its augmentations
    from (seed, epoch, row), so the batches do not depend on it."""

    def __init__(self, builder, pipeline, batcher, num_workers: int = 0,
                 prefetch: int = 64):
        self.builder = builder
        self.pipeline = pipeline
        self.batcher = batcher
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.epoch = 0

    def _items(self, epoch: int):
        n = len(self.builder)

        def load(i):
            return self.pipeline(self.builder.get(i), (epoch, i))

        if self.num_workers <= 1:
            for i in range(n):
                item = load(i)
                if not item.get("bad"):
                    yield item
            return
        import concurrent.futures as cf
        from collections import deque

        with cf.ThreadPoolExecutor(self.num_workers) as ex:
            pending: deque = deque()
            idx = 0
            while idx < n or pending:
                while idx < n and len(pending) < self.prefetch:
                    pending.append(ex.submit(load, idx))
                    idx += 1
                item = pending.popleft().result()
                if not item.get("bad"):
                    yield item

    def __iter__(self) -> Iterator[Batch]:
        epoch, self.epoch = self.epoch, self.epoch + 1
        return self.batcher.batches(self._items(epoch))

    @classmethod
    def from_config(cls, conf: dict, lang, mode: str = "train"):
        from .builder import ASRDatasetBuilder
        from .transforms import Pipeline, parse_stages

        if (conf.get("synth_tone") or {}).get("enabled"):
            raise NotImplementedError(
                "libreasr_tpu_torch: the synthetic tone corpus is not ported")
        seed = conf.get("seed", 42)
        builder = ASRDatasetBuilder.from_config(conf, mode)
        tf = conf.get("transforms", {}) or {}
        stages = (parse_stages(tf.get("x", []), conf, lang)
                  + parse_stages(tf.get("y", []), conf, lang))
        pipeline = Pipeline(stages, training=mode == "train", seed=seed)
        batcher = BucketBatcher(
            buckets_from_config(conf),
            shuffle=conf.get("shuffle", True) and mode == "train",
            seed=seed, drop_last=conf.get("drop_last", False),
            transfer_dtype=conf.get("transfer_dtype", "int16"),
        )
        return cls(builder, pipeline, batcher,
                   num_workers=conf.get("num_workers", 0))
