"""The port's flax-msgpack bundle reader against flax's own
(`libreasr_tpu.training.checkpoint.load_bundle`), on both golden
bundles. Every leaf must be bit-identical: the reader only reinterprets
bytes."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from libreasr_tpu.models.transducer import TransducerConfig, init_transducer
from libreasr_tpu.training import checkpoint as jax_ckpt
from libreasr_tpu_torch import checkpoint as torch_ckpt
from libreasr_tpu_torch.convert import flatten_variables

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "golden")


def _flat_jax(tree):
    return flatten_variables(serialization.to_state_dict(tree))


@pytest.mark.parametrize("name", ["model.tar.gz", "model_bpe.tar.gz"])
def test_bundle_leaves_equal_flax(name, tmp_path):
    path = os.path.join(FIXTURES, name)
    conf = jax_ckpt.read_bundle_conf(path, "en")
    assert torch_ckpt.read_bundle_conf(path, "en") == conf
    _, template = init_transducer(
        TransducerConfig.from_config(conf), jax.random.PRNGKey(0)
    )
    ref, ref_tok, ref_lm, ref_conf = jax_ckpt.load_bundle(
        path, "en", template, extract_to=str(tmp_path / "jax")
    )
    got, tok, lm, got_conf = torch_ckpt.load_bundle(
        path, "en", extract_to=str(tmp_path / "torch")
    )
    want = _flat_jax(ref)
    have = flatten_variables(got)
    assert sorted(have) == sorted(want)
    for k, v in want.items():
        assert have[k].dtype == v.dtype, k
        np.testing.assert_array_equal(have[k], v, err_msg=k)
    assert got_conf == ref_conf
    assert (tok is None) == (ref_tok is None)
    if tok is not None:
        assert os.path.basename(tok) == os.path.basename(ref_tok)
        with open(tok, "rb") as a, open(ref_tok, "rb") as b:
            assert a.read() == b.read()
    assert lm == ref_lm
    if lm is not None:
        want_lm = _flat_jax(serialization.msgpack_restore(ref_lm))
        have_lm = flatten_variables(torch_ckpt.msgpack_restore(lm))
        assert sorted(have_lm) == sorted(want_lm)
        for k, v in want_lm.items():
            np.testing.assert_array_equal(have_lm[k], v, err_msg=k)


def test_msgpack_ext_types_roundtrip():
    """ndarray, numpy scalar and bfloat16 leaves written by flax."""
    rng = np.random.default_rng(0)
    bf = rng.standard_normal((3, 5)).astype(np.float32)
    tree = {
        "a": rng.standard_normal((2, 3)).astype(np.float32),
        "b": {"i": np.arange(7, dtype=np.int32), "s": np.float32(1.5)},
        "c": jnp.asarray(bf, jnp.bfloat16),
        "n": 3,
    }
    got = torch_ckpt.msgpack_restore(serialization.to_bytes(tree))
    np.testing.assert_array_equal(got["a"], tree["a"])
    np.testing.assert_array_equal(got["b"]["i"], tree["b"]["i"])
    assert got["b"]["s"] == np.float32(1.5)
    assert isinstance(got["b"]["s"], np.floating)
    # bf16 widens exactly to float32
    np.testing.assert_array_equal(
        got["c"], np.asarray(jnp.asarray(bf, jnp.bfloat16).astype(jnp.float32))
    )
    assert got["n"] == 3


def test_read_bundle_conf_missing_lang_is_empty():
    path = os.path.join(FIXTURES, "model.tar.gz")
    assert torch_ckpt.read_bundle_conf(path, "de") == {}


def test_msgpack_serialize_matches_flax():
    """The port's writer gives flax's bytes, and flax reads them back."""
    rng = np.random.default_rng(1)
    tree = {
        "params": {
            "cell": {"kernel": {"q": rng.integers(-127, 128, (4, 8)).astype(np.int8),
                                "scale": rng.random((1, 8)).astype(np.float32)},
                     "bias": rng.standard_normal(8).astype(np.float32)},
            "h0": np.zeros((2, 1, 4), np.float32),
        },
        "step": np.int32(7),
    }
    data = torch_ckpt.msgpack_serialize(tree)
    assert data == serialization.msgpack_serialize(tree)
    back = serialization.msgpack_restore(data)
    for k, v in flatten_variables(tree).items():
        got = flatten_variables(back)[k]
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)
    with pytest.raises(TypeError, match="cannot serialize"):
        torch_ckpt.msgpack_serialize({"x": object()})


def test_save_bundle_layout_reads_in_jax(tmp_path):
    path = os.path.join(FIXTURES, "model_bpe.tar.gz")
    variables, tok, _, conf = torch_ckpt.load_bundle(
        path, "en", extract_to=str(tmp_path / "src"))
    out = torch_ckpt.save_bundle(str(tmp_path / "out" / "b.tar.gz"), "en",
                                 variables, conf, tokenizer_file=tok)
    assert jax_ckpt.read_bundle_conf(out, "en") == conf
    _, template = init_transducer(
        TransducerConfig.from_config(conf), jax.random.PRNGKey(0)
    )
    ref, ref_tok, ref_lm, _ = jax_ckpt.load_bundle(
        out, "en", template, extract_to=str(tmp_path / "jax"))
    want = flatten_variables(variables)
    have = _flat_jax(ref)
    assert sorted(have) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(have[k], v, err_msg=k)
    with open(tok, "rb") as a, open(ref_tok, "rb") as b:
        assert a.read() == b.read()
    assert ref_lm is None  # no lm_variables were given


def test_char_bundle_extracted_over_bpe_bundle_loads_clean(tmp_path):
    """load_bundle decides which members exist from the archive, not from
    the directory: the char golden bundle extracted where the BPE one was
    extracted before loads with no LM and the char tokenizer, and
    transcribes the 8 golden clips exactly (it used to pick up the BPE
    bundle's tokenizer and V-64 LM left in the directory)."""
    from libreasr_tpu_torch.api import ASRBundle
    from libreasr_tpu_torch.data.audio import read_wav
    from libreasr_tpu_torch.data.language import CharLanguage

    d = str(tmp_path / "shared")
    bpe = ASRBundle.from_bundle(os.path.join(FIXTURES, "model_bpe.tar.gz"),
                                extract_to=d, device="cpu")
    assert bpe.lm is not None and not isinstance(bpe.lang, CharLanguage)
    assert os.path.exists(os.path.join(d, "en", "lm.msgpack"))
    char_path = os.path.join(FIXTURES, "model.tar.gz")
    _, tok, lm, _ = torch_ckpt.load_bundle(char_path, "en", extract_to=d)
    assert tok is None and lm is None
    char = ASRBundle.from_bundle(char_path, extract_to=d, device="cpu")
    assert char.lm is None and isinstance(char.lang, CharLanguage)
    audio = np.zeros((8, 16000), np.float32)
    for i in range(8):
        audio[i] = read_wav(os.path.join(FIXTURES, f"s-{i:03d}.wav"))[0][0]
    texts, _ = char.transcribe_batch(audio, np.full(8, 16000), use_lm=True)
    assert texts == ["yes", "no", "hello world", "stop now", "go left",
                     "turn right", "one two", "three four"]
