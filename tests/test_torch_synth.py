"""The port's streamed tone corpus (libreasr_tpu_torch/data/synth.py)
against the JAX package's on the same seed: texts, speakers, pcm and
ids bit for bit for train epochs 0 and 1 and the valid and test sets;
the batches through both batchers; the sampled length histogram; the
bucket ladder derived from it. Then the stream's own rules, as
tests/test_synth_stream.py holds them for JAX: fresh train epochs that
never hold a reserved sentence or a held-out speaker, and fixed,
disjoint dev and test sets on held-out speakers."""

import numpy as np
import pytest
import torch

from libreasr_tpu_torch.data.batching import ASRDataset, buckets_from_histogram
from libreasr_tpu_torch.data.language import get_language
from libreasr_tpu_torch.data.synth import ToneStreamDataset


def _conf(**kw):
    sc = {"enabled": True, "hours_per_epoch": 0.01, "speakers": 4,
          "heldout_speakers": 2, "eval_utts": 8, "seed": 7}
    sc.update(kw)
    return {"synth_tone": sc, "num_workers": 2,
            "buckets": [{"max_samples": 80000, "y_max": 64, "bs": 4}]}


@pytest.fixture(scope="module")
def langs():
    from libreasr_tpu.data.language import get_language as jax_language

    return get_language()[0], jax_language()[0]


def _pair(langs, mode, conf=None):
    from libreasr_tpu.data.synth import ToneStreamDataset as JaxTone

    conf = conf or _conf()
    return (ToneStreamDataset.from_config(conf, langs[0], mode),
            JaxTone.from_config(conf, langs[1], mode))


@pytest.mark.parametrize("mode,epoch", [("train", 0), ("train", 1),
                                        ("valid", 0), ("test", 0)])
def test_items_bit_equal_jax(langs, mode, epoch):
    ds, jds = _pair(langs, mode)
    specs = ds._epoch_specs(epoch)
    assert specs == jds._epoch_specs(epoch) and len(specs) > 0
    for text, spk, seed in specs:
        it, jit = ds._make_item(text, spk, seed), jds._make_item(text, spk, seed)
        assert it["text"] == jit["text"] == text
        assert it["speaker"] == jit["speaker"] == spk
        assert it["ids"] == jit["ids"]
        assert it["audio"].dtype == jit["audio"].dtype == np.float32
        np.testing.assert_array_equal(it["audio"], jit["audio"])


@pytest.mark.parametrize("mode", ["train", "valid", "test"])
def test_batches_equal_jax(langs, mode):
    """Two passes each: the train stream's epochs 0 and 1, the eval sets
    twice (the same batches both times)."""
    ds, jds = _pair(langs, mode, _conf(hours_per_epoch=0.02))
    for _ in range(2):
        got, want = list(iter(ds)), list(iter(jds))
        assert len(got) == len(want) > 0
        for b, jb in zip(got, want):
            assert b.audio.dtype == torch.int16  # the int16 transfer default
            for x, y in zip(b, jb):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert ds.epoch == jds.epoch == (2 if mode == "train" else 0)


def test_sample_lengths_equal_jax(langs):
    ds, jds = _pair(langs, "train")
    xl, yl = ds.sample_lengths(32)
    jxl, jyl = jds.sample_lengths(32)
    np.testing.assert_array_equal(xl, jxl)
    np.testing.assert_array_equal(yl, jyl)
    assert len(xl) == 32 and (xl > 300).all() and (yl > 2).all()


@pytest.mark.parametrize("data_axis", [1, 8])
@pytest.mark.parametrize("source", ["tone", "random"])
def test_buckets_from_histogram_equal_jax(langs, data_axis, source):
    from libreasr_tpu.data.batching import buckets_from_histogram as jax_ladder

    if source == "tone":
        xl, yl = _pair(langs, "train")[0].sample_lengths(64)
    else:
        rng = np.random.default_rng(3)
        xl = rng.uniform(400, 16000, 500)
        yl = rng.integers(2, 120, 500)
    for kw in ({}, {"n_buckets": 3, "bs_max": 16}, {"frame_budget": 9000}):
        got = buckets_from_histogram(xl, yl, data_axis=data_axis, **kw)
        want = jax_ladder(xl, yl, data_axis=data_axis, **kw)
        assert [b.key for b in got] == [b.key for b in want]
        assert got and all(b.bs % data_axis == 0 for b in got)


def test_epochs_are_fresh_and_reject_reserved(langs):
    ds = ToneStreamDataset.from_config(_conf(), langs[0], "train")
    t0 = {t for t, _, _ in ds._epoch_specs(0)}
    t1 = {t for t, _, _ in ds._epoch_specs(1)}
    assert t0 and t1 and t0 != t1
    assert len(t0 & t1) < len(t0) // 2
    assert not (t0 | t1) & ds._reserved
    assert {s for _, s, _ in ds._epoch_specs(0)} <= set(ds.train_speakers)


def test_eval_split_deterministic_and_heldout(langs):
    va = ToneStreamDataset.from_config(_conf(), langs[0], "valid")
    vb = ToneStreamDataset.from_config(_conf(), langs[0], "valid")
    ba, bb, bc = list(iter(va)), list(iter(vb)), list(iter(va))
    assert len(ba) == len(bb) == len(bc) > 0
    for x, y, z in zip(ba, bb, bc):
        assert torch.equal(x.audio, y.audio) and torch.equal(x.audio, z.audio)
        assert torch.equal(x.labels, y.labels)
    specs_v = va._epoch_specs(0)
    assert {s for _, s, _ in specs_v} <= set(va.held_speakers)
    assert not set(va.held_speakers) & set(va.train_speakers)
    te = ToneStreamDataset.from_config(_conf(), langs[0], "test")
    assert not {t for t, _, _ in te._epoch_specs(0)} & {t for t, _, _ in specs_v}


def test_ids_match_language(langs):
    ds = ToneStreamDataset.from_config(_conf(), langs[0], "valid")
    text, spk, seed = ds._epoch_specs(0)[0]
    item = ds._make_item(text, spk, seed)
    assert item["ids"] == langs[0].numericalize(text)
    assert item["audio"].dtype == np.float32
    assert 8000 < len(item["audio"]) < 80000


def test_from_config_dispatch(langs):
    """ASRDataset.from_config returns the stream for a synth_tone config;
    its batcher drops ragged leftovers only in train mode."""
    ds = ASRDataset.from_config({**_conf(), "drop_last": True}, langs[0], "train")
    assert isinstance(ds, ToneStreamDataset) and ds.batcher.drop_last
    assert not ds.batcher.shuffle
    b = next(iter(ds))
    assert b.audio.ndim == 2 and b.labels.ndim == 2 and b.audio.dtype == torch.int16
    ev = ASRDataset.from_config({**_conf(), "drop_last": True}, langs[0], "valid")
    assert isinstance(ev, ToneStreamDataset) and not ev.batcher.drop_last
    assert len(ev.builder) == 8 and "tone-stream/valid" in ev.builder.stats()
