"""The port's BPE tokenizer against the JAX package's: on the tokenizer of
the BPE golden bundle, the same vocabulary and the same text for the
same ids, specials, blanks and EOS included; its trainer (the port's
copy of the C++ one) writes the same model bytes, and its encoder gives
the same ids, on the tone recipe's corpus and tests/test_native.py's."""

import os
import tarfile

import numpy as np
import pytest

from libreasr_tpu.data.bpe import BPELanguage as JaxBPE
from libreasr_tpu.data.bpe import _PyBPE
from libreasr_tpu_torch.data.bpe import BPELanguage
from libreasr_tpu_torch.data.language import get_language

BUNDLE = os.path.join(os.path.dirname(__file__), "fixtures", "golden",
                      "model_bpe.tar.gz")


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("bpe")
    with tarfile.open(BUNDLE, "r:gz") as tar:
        tar.extract("en/tokenizer.labpe-model", d, filter="data")
    return str(d / "en" / "tokenizer.labpe-model")


def test_vocabulary_matches_jax(model_file):
    lang, vocab_sz = get_language(model_file=model_file)
    assert isinstance(lang, BPELanguage)
    ref = _PyBPE(model_file)
    assert lang.vocab == ref.vocab
    assert vocab_sz == len(lang) == ref.vocab_size() == len(JaxBPE(model_file))
    assert (lang.blank, lang.sos, lang.eos) == (0, 2, 3)
    assert lang.model_file == model_file


@pytest.mark.parametrize("seed", range(4))
def test_denumericalize_matches_jax(model_file, seed):
    lang = BPELanguage(model_file)
    ref = JaxBPE(model_file)
    rng = np.random.default_rng(seed)
    for _ in range(50):
        ids = [int(i) for i in rng.integers(0, len(lang), rng.integers(0, 12))]
        assert lang.denumericalize(ids) == ref.denumericalize(ids), ids
    for text in ("hello world", "turn right", "three four"):
        ids = ref.numericalize(text)
        assert ids[-1] == 3  # EOS
        assert lang.denumericalize(ids) == text


def test_bad_model_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        BPELanguage(str(tmp_path / "missing"))
    bad = tmp_path / "bad"
    bad.write_text("YTTM\n1\n0\nx\n")
    with pytest.raises(ValueError, match="LABPE1"):
        BPELanguage(str(bad))


# ---- training and encoding --------------------------------------------------

NATIVE_LINES = [
    "the quick brown fox jumps over the lazy dog",
    "the dog barks at the quick fox",
    "a lazy brown dog sleeps all day",
    "quick quick quick the the the",
] * 50  # tests/test_native.py's corpus


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The tone recipe's tokenizer corpus (8,000 sentences from rng
    [42, 6]) and tests/test_native.py's."""
    from libreasr_tpu_torch.data.synth import sentences

    d = tmp_path_factory.mktemp("corpora")
    tone = d / "tone.txt"
    tone.write_text("".join(s + "\n" for s in
                            sentences(np.random.default_rng([42, 6]), 8000)))
    native = d / "native.txt"
    native.write_text("\n".join(NATIVE_LINES))
    return {"tone": str(tone), "native": str(native)}


CASES = {"tone64": ("tone", 64), "tone128": ("tone", 128),
         "tone2048": ("tone", 2048), "native80": ("native", 80)}


@pytest.fixture(scope="module")
def trained_models(corpora, tmp_path_factory):
    """{case: (port model, JAX model)}, each trained by its own package."""
    from libreasr_tpu.data.bpe import train_bpe as jax_train_bpe
    from libreasr_tpu_torch.data.bpe import train_bpe

    d = tmp_path_factory.mktemp("models")
    out = {}
    for case, (corpus, vocab) in CASES.items():
        mine, ref = str(d / f"{case}.port"), str(d / f"{case}.jax")
        train_bpe(corpora[corpus], mine, vocab)
        jax_train_bpe(corpora[corpus], ref, vocab)
        out[case] = (mine, ref)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_train_bpe_bytes_equal_jax(trained_models, case):
    mine, ref = trained_models[case]
    with open(mine, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert len(BPELanguage(mine)) <= CASES[case][1]


@pytest.mark.parametrize("case", [*CASES, "golden"])
def test_numericalize_matches_jax(trained_models, model_file, case):
    from libreasr_tpu_torch.data.synth import sentences

    path = model_file if case == "golden" else trained_models[case][1]
    lang, ref = BPELanguage(path), JaxBPE(path)
    texts = (sentences(np.random.default_rng(5), 200) + NATIVE_LINES[:4]
             + TEXTS + ["  Hello   World ", "", "xyzzy qq", "the"])
    for text in texts:
        for kw in ({}, {"sos": True}, {"append_eos": False},
                   {"sos": True, "append_eos": False}):
            assert lang.numericalize(text, **kw) == ref.numericalize(text, **kw), \
                (text, kw)
        assert lang.denumericalize(lang.numericalize(text)) == \
            ref.denumericalize(ref.numericalize(text))


TEXTS = ["yes", "no", "hello world", "stop now", "go left", "turn right",
         "one two", "three four"]


def test_roundtrip_and_frequent_words(trained_models):
    """tests/test_native.py's BPE cases through the port."""
    lang = BPELanguage(trained_models["native80"][0])
    ids = lang.numericalize("the quick brown fox")
    assert ids[-1] == lang.eos and all(i >= 4 for i in ids[:-1])
    assert lang.denumericalize(ids) == "the quick brown fox"
    assert lang.denumericalize([0] + lang.numericalize("lazy dog") + [0, 0]) == \
        "lazy dog"
    assert len(lang.numericalize("the", append_eos=False)) == 1


def test_bpe_dropout_splits_words(model_file, tmp_path):
    """Dropout 0 is the plain encoding whatever the seed, dropout > 0
    splits words further, and a model the C library cannot read raises."""
    lang = BPELanguage(model_file)
    assert lang.numericalize("hello", dropout=0.0, seed=3) == lang.numericalize("hello")
    text = "hello world turn right three four"
    plain = lang.numericalize(text)
    dropped = lang.numericalize(text, dropout=0.5, seed=7)
    assert len(dropped) > len(plain)
    assert lang.denumericalize(dropped) == text
    gone = BPELanguage(model_file)
    gone.model_file = str(tmp_path / "missing")
    with pytest.raises(ValueError, match="LABPE1"):
        gone.numericalize("hello", dropout=0.1)


@pytest.mark.parametrize("dropout", [0.05, 0.3, 1.0])
def test_bpe_dropout_ids_equal_jax(model_file, dropout):
    """With the same seed (and this host's libc rand_r on both sides) the
    ids are JAX's native encoder's, id for id, for several seeds; seed 0
    stands for 12345 on both sides. At 0.3 the seeds draw different
    splits; at 1.0 every merge is skipped, whatever the seed."""
    lang, ref = BPELanguage(model_file), JaxBPE(model_file)
    assert ref._py is None  # JAX's native encoder, not its Python fallback
    texts = ["hello world", "turn right now", "three four stop go left",
             "The Quick Brown Fox"]
    seen = set()
    for seed in (0, 1, 7, 12345, 2**31 + 5):
        for text in texts:
            ids = lang.numericalize(text, dropout=dropout, seed=seed, sos=True)
            assert ids == ref.numericalize(text, dropout=dropout, seed=seed,
                                           sos=True), (seed, text)
            seen.add(tuple(ids))
    if dropout == 0.3:
        assert len(seen) > len(texts)
    if dropout == 1.0:
        assert len(seen) == len(texts)


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_failed_trainer_build_raises(compiler, corpora, monkeypatch, tmp_path):
    """No Python trainer takes over (it would give other ids): a compiler
    that is missing or fails raises, with its output."""
    from libreasr_tpu_torch.data.bpe import train_bpe
    from libreasr_tpu_torch.ops.kernels import build

    cxx = tmp_path / "bin" / "cxx"
    if compiler == "failing":
        cxx.parent.mkdir()
        cxx.write_text("#!/bin/sh\necho 'bpe_train.cpp:1: error: broken' >&2\nexit 1\n")
        cxx.chmod(0o755)
    monkeypatch.setattr(build, "HOST_CXX", str(cxx))
    monkeypatch.setenv("CXX", "g++")  # not read
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.delitem(build._libs, "bpe_train", raising=False)
    with pytest.raises(RuntimeError, match="host build of bpe_train failed") as e:
        train_bpe(corpora["native"], str(tmp_path / "m"), 80)
    if compiler == "failing":
        assert "error: broken" in str(e.value)
    assert not (tmp_path / "m").exists()
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path / "build"))


def test_train_bpe_bad_corpus_raises(tmp_path):
    from libreasr_tpu_torch.data.bpe import train_bpe

    with pytest.raises(RuntimeError, match="rc=-1"):
        train_bpe(str(tmp_path / "missing.txt"), str(tmp_path / "m"), 64)
    (tmp_path / "empty.txt").write_text("\n \n")
    with pytest.raises(RuntimeError, match="rc=-2"):
        train_bpe(str(tmp_path / "empty.txt"), str(tmp_path / "m"), 64)
