"""The port's BPE tokenizer (LABPE1 reader and decoder) against the JAX
package's on the tokenizer of the BPE golden bundle: the same vocabulary
and the same text for the same ids, specials, blanks and EOS included."""

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
