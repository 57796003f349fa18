"""The port's data layer (libreasr_tpu_torch.data) against the JAX
package's, on a corpus of noise WAVs: builder rows, the host pipeline's
non-augmenting stages, and bucketed batches, all equal."""

import numpy as np
import pandas as pd
import pytest
from helpers.noise_corpus import make_noise_corpus, tiny_conf

from libreasr_tpu.data import audio as jaudio
from libreasr_tpu.data.batching import ASRDataset as JaxDataset
from libreasr_tpu.data.builder import ASRDatasetBuilder as JaxBuilder
from libreasr_tpu.data.language import get_language as jax_language
from libreasr_tpu.data.transforms import Pipeline as JaxPipeline
from libreasr_tpu.data.transforms import parse_stages as jax_stages
from libreasr_tpu.training import metrics as jmetrics
from libreasr_tpu_torch.data import audio as taudio
from libreasr_tpu_torch.data.batching import ASRDataset
from libreasr_tpu_torch.data.builder import ASRDatasetBuilder
from libreasr_tpu_torch.data.language import get_language
from libreasr_tpu_torch.data.transforms import Pipeline, parse_stages
from libreasr_tpu_torch.training import metrics as tmetrics


@pytest.fixture(scope="module")
def conf(tmp_path_factory):
    root = tmp_path_factory.mktemp("noise")
    c = tiny_conf(make_noise_corpus(root), str(root / "no-tokenizer"))
    # one row past the limits, one marked bad: both must be dropped alike
    csv = root / "asr-dataset-train.csv"
    df = pd.read_csv(csv)
    extra = df.iloc[:2].copy()
    extra["xlen"] = [7000.0, 1500.0]
    extra["bad"] = [False, True]
    pd.concat([df, extra]).to_csv(csv, index=False)
    return c


@pytest.mark.parametrize("mode", ["train", "valid"])
def test_builder_rows_match_jax(conf, mode):
    jb, tb = JaxBuilder.from_config(conf, mode), ASRDatasetBuilder.from_config(conf, mode)
    assert len(tb) == len(jb) > 0
    for i in range(len(jb)):
        want, got = jb.get(i), tb.get(i)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == want[k], (i, k, got[k], want[k])
    assert tb.stats() == pytest.approx(jb.stats())


@pytest.mark.parametrize("seed", [0, 42, 7])
def test_shuffle_is_pandas_sample(seed):
    """The permutation pandas' sample(frac=1, random_state=seed) takes."""
    n = 37
    want = pd.DataFrame({"i": range(n)}).sample(frac=1.0, random_state=seed)["i"]
    b = ASRDatasetBuilder(rows=[{"i": i} for i in range(n)]).shuffle(seed)
    assert [r["i"] for r in b.rows] == list(want)


def test_pipeline_matches_jax(conf):
    """OpenAudio, ChannelCut, Resample, PadderCutter and the label stages
    (no augmentation): the same audio and ids for every row."""
    lang, _ = get_language()
    jlang, _ = jax_language()
    tf = conf["transforms"]
    ours = Pipeline(parse_stages(tf["x"], conf, lang) + parse_stages(tf["y"], conf, lang),
                    training=False)
    theirs = JaxPipeline(jax_stages(tf["x"], conf, jlang)
                         + jax_stages(tf["y"], conf, jlang), training=False)
    b = ASRDatasetBuilder.from_config(conf, "train")
    for i in range(len(b)):
        got, want = ours(b.get(i)), theirs(JaxBuilder.from_config(conf, "train").get(i))
        np.testing.assert_array_equal(got["audio"], want["audio"])
        assert got["ids"] == want["ids"] and got["ylen"] == want["ylen"]
        assert got["sr"] == want["sr"] == 16000


def test_augmenting_stages_are_seeded(conf):
    """Training stages draw from (seed, epoch, row): the same key gives
    the same audio, another key another; eval skips them."""
    lang, _ = get_language()
    spec = [{"name": "OpenAudio"}, {"name": "ChannelCut"},
            {"name": "SpeedPerturb", "wrap": True, "args": {"delta": 10}},
            {"name": "ChangeVolume", "wrap": True, "args": {"pcent": 0.03}},
            {"name": "AddNoise", "wrap": True, "args": {"noise_level": 0.05}},
            {"name": "SignalShifter", "wrap": True, "args": {"max_time": 0.1}},
            {"name": "PadderCutter"}]
    pipe = Pipeline(parse_stages(spec, conf, lang), training=True, seed=5)
    row = ASRDatasetBuilder.from_config(conf, "train").get(0)
    a, b = pipe(dict(row), (0, 0)), pipe(dict(row), (0, 0))
    c = pipe(dict(row), (0, 1))
    np.testing.assert_array_equal(a["audio"], b["audio"])
    assert len(a["audio"]) != len(c["audio"]) or not np.array_equal(a["audio"], c["audio"])
    plain = Pipeline(parse_stages(spec, conf, lang), training=False)(dict(row))
    assert len(plain["audio"]) == 24000


@pytest.mark.parametrize("mode", ["train", "valid"])
def test_batches_match_jax(conf, mode):
    """Bucketed, padded int16 batches equal JAX's ASRDataset's, batch for
    batch, two epochs (the window shuffle's generator carries over)."""
    lang, _ = get_language()
    jlang, _ = jax_language()
    ours, theirs = ASRDataset.from_config(conf, lang, mode), JaxDataset.from_config(conf, jlang, mode)
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.numpy().dtype == np.asarray(b).dtype
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_resample_matches_jax_fallback():
    """The JAX package's resampler as it runs: its native library
    (native/audio.cpp `la_resample`, built on demand), of which the
    port's resample is a numpy copy; scipy's resample_poly, the JAX
    package's fallback without that library, is no longer the port's."""
    assert jaudio.audio_lib() is not None
    x = np.random.default_rng(0).standard_normal((2, 4410)).astype(np.float32)
    for sr_in, sr_out in ((44100, 16000), (8000, 16000), (16000, 16000)):
        np.testing.assert_array_equal(taudio.resample(x, sr_in, sr_out),
                                      jaudio.resample(x, sr_in, sr_out))
        np.testing.assert_array_equal(taudio.resample(x[0], sr_in, sr_out),
                                      jaudio.resample(x[0], sr_in, sr_out))


def test_compressed_audio_raises(tmp_path):
    """A compressed file that does not decode (missing, or garbage)
    raises AudioReadError; nothing falls back to another reader."""
    for ext in (".flac", ".ogg", ".mp3"):
        with pytest.raises(taudio.AudioReadError, match="decode failed"):
            taudio.read_audio(str(tmp_path / f"a{ext}"))
        garbage = tmp_path / f"g{ext}"
        garbage.write_bytes(b"\x00\x01not-audio" * 64)
        with pytest.raises(taudio.AudioReadError, match="decode failed"):
            taudio.read_audio(str(garbage))


@pytest.mark.parametrize("pred,target", [
    ("a b c", "a b c"), ("a x c", "a b c"), ("ab c", "abc"), ("", "a b"),
    ("", ""), ("x", ""), ("hello wrld", "hello world"), ("the cat", "a cat sat"),
])
def test_metrics_match_jax(pred, target):
    assert tmetrics.wer(pred, target) == pytest.approx(jmetrics.wer(pred, target))
    assert tmetrics.cer(pred, target) == pytest.approx(jmetrics.cer(pred, target))
