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
    assert ref_lm is None  # the port has no LM to write
