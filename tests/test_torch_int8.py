"""int8-quantized bundles, both ways between the port and the JAX
package, on the golden bundle's trained weights (CPU):

- JAX quantize() -> JAX save() -> port from_bundle: the 8 texts exactly,
  and the same tokens and alignment scores as JAX's decode program, at
  1 s (T 12: the int8 scan cells) and zero-padded to 3 s (T 37: the int8
  sequence recurrence; JAX runs kernel C in interpret mode);
- port quantize() -> port save() -> JAX from_bundle: the 8 texts exactly,
  and every leaf equal to JAX's own quantization of the same bundle;
- the int8 joint (decoder_fns(quantized=True)) decodes exactly with the
  same tokens as JAX's (tests/test_quant_decode.py).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from libreasr_tpu.api import ASRBundle as JaxBundle
from libreasr_tpu.models.decode import greedy_decode as jax_greedy
from libreasr_tpu.ops.frontend import features_batch as jax_features
from libreasr_tpu_torch.api import ASRBundle
from libreasr_tpu_torch.convert import (
    export_variables, flatten_variables, load_jax_variables,
)
from libreasr_tpu_torch.data.audio import read_wav
from libreasr_tpu_torch.models.decode import greedy_decode
from libreasr_tpu_torch.models.modules import QuantizedWeight
from libreasr_tpu_torch.models.transducer import Transducer
from libreasr_tpu_torch.ops.frontend import features_batch

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
GOLDEN = os.path.join(FIXTURES, "model.tar.gz")
TEXTS = [
    "yes", "no", "hello world", "stop now",
    "go left", "turn right", "one two", "three four",
]


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("int8")
    jq = JaxBundle.from_bundle(GOLDEN, extract_to=str(tmp / "j")).quantize()
    jax_saved = jq.save(str(tmp / "jax_int8.tar.gz"))
    audio = np.zeros((8, 16000), np.float32)
    for i in range(8):
        pcm, _ = read_wav(os.path.join(FIXTURES, f"s-{i:03d}.wav"))
        audio[i] = pcm[0]
    return jq, jax_saved, audio, tmp


@pytest.mark.parametrize("samples", [16000, 48000])
def test_jax_quantized_bundle_decodes_exact_in_port(golden, samples, monkeypatch):
    monkeypatch.setenv("LIBREASR_FORCE_PALLAS", "1")
    jq, jax_saved, audio, tmp = golden
    tb = ASRBundle.from_bundle(jax_saved, extract_to=str(tmp / f"t{samples}"),
                               device="cpu")
    assert tb.cfg.quantized_cells
    cell = tb.model.encoder.rnn_stack.layer(0).cell
    assert isinstance(cell.recurrent_kernel, QuantizedWeight)
    assert cell.recurrent_kernel.q.dtype == torch.int8
    padded = np.zeros((8, samples), np.float32)
    padded[:, :16000] = audio
    lengths = np.full(8, 16000)
    texts, metrics = tb.transcribe_batch(padded, lengths)
    assert texts == TEXTS
    toks, tok_lens, _ = tb.decode_tokens(padded, lengths)
    jtoks, jlens, jmetrics = jq._decode_program(False, 3, 256)(
        jq.variables, None, padded, lengths)
    np.testing.assert_array_equal(tok_lens, np.asarray(jlens))
    np.testing.assert_array_equal(toks, np.asarray(jtoks))
    np.testing.assert_allclose(metrics["alignment_score"],
                               np.asarray(jmetrics["alignment_score"]), rtol=1e-6)


def test_port_quantized_bundle_loads_in_jax(golden):
    jq, _, audio, tmp = golden
    tb = ASRBundle.from_bundle(GOLDEN, extract_to=str(tmp / "p"), device="cpu")
    tb.quantize()
    assert tb.conf["quantized_cells"] is True
    out = tb.save(str(tmp / "port_int8.tar.gz"))
    jb = JaxBundle.from_bundle(out, extract_to=str(tmp / "pj"))
    assert jb.conf.get("quantized_cells") is True
    want = flatten_variables(serialization.to_state_dict(
        jax.tree_util.tree_map(np.asarray, jq.variables)))
    have = flatten_variables(serialization.to_state_dict(
        jax.tree_util.tree_map(np.asarray, jb.variables)))
    assert sorted(have) == sorted(want)
    assert sum(k.endswith(".q") for k in have) == 6  # 3 layers x 2 matrices
    for k, v in want.items():
        assert have[k].dtype == v.dtype, k
        np.testing.assert_array_equal(have[k], v, err_msg=k)
    texts, _ = jb.transcribe_batch(audio, np.full(8, 16000))
    assert texts == TEXTS


def test_export_load_roundtrip_and_dtype_guard(golden):
    _, jax_saved, _, tmp = golden
    tb = ASRBundle.from_bundle(jax_saved, extract_to=str(tmp / "r"), device="cpu")
    variables = export_variables(tb.model)
    fresh = Transducer(tb.cfg, seed=3)
    load_jax_variables(fresh, variables)
    for (name, a), (_, b) in zip(tb.model.state_dict().items(),
                                 fresh.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    layer0 = fresh.encoder.rnn_stack.layer(0).cell.recurrent_kernel
    assert torch.equal(layer0.packed, tb.model.encoder.rnn_stack.layer(0)
                       .cell.recurrent_kernel.packed)
    # an int8 leaf never lands in a float tensor, nor a float in an int8
    bad = copy.deepcopy(variables)
    enc = bad["params"]["encoder"]["rnn_stack"]["layer0"]["cell"]
    enc["recurrent_kernel"]["q"] = enc["recurrent_kernel"]["q"].astype(np.float32)
    with pytest.raises(TypeError, match="recurrent_kernel.q"):
        load_jax_variables(fresh, bad)


def test_int8_joint_decode_exact_and_matches_jax(golden):
    _, _, audio, tmp = golden
    jb = JaxBundle.from_bundle(GOLDEN, extract_to=str(tmp / "jj"))
    tb = ASRBundle.from_bundle(GOLDEN, extract_to=str(tmp / "tj"), device="cpu")
    lengths = np.full(8, 16000)
    jfeats, jflens = jax_features(jnp.asarray(audio), jnp.asarray(lengths),
                                  jb.frontend)
    jenc, _ = jb.encode(jfeats, jflens)
    jtoks, jlens, _, _ = jax_greedy(
        jb.decoder_fns(use_lm=False, quantized=True), jenc, jflens,
        vocab_sz=jb.cfg.vocab_sz, blank=jb.cfg.blank, bos=jb.cfg.bos,
        max_tokens=64)
    with torch.inference_mode():
        feats, flens = features_batch(torch.from_numpy(audio),
                                      torch.from_numpy(lengths), tb.frontend)
        enc, _ = tb.model.encode(feats, lengths=flens)
        toks, lens, _, _ = greedy_decode(
            tb.decoder_fns(use_lm=False, quantized=True), enc, flens, blank=tb.cfg.blank,
            bos=tb.cfg.bos, max_tokens=64)
    texts = [tb.lang.denumericalize(list(toks[i, : lens[i]].numpy()))
             for i in range(8)]
    assert texts == TEXTS
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))


def test_from_config_with_quantized_cells_is_seeded():
    from libreasr_tpu_torch.config import apply_overrides, open_config

    conf = apply_overrides(open_config(), ["inference"])
    conf["model"].update(embed_sz=16, hidden_sz=24, out_sz=24, joint_sz=16,
                         vocab_sz=40)
    conf["model"]["encoder"]["num_layers"] = 2
    conf["model"]["predictor"]["num_layers"] = 1
    plain = ASRBundle.from_config(copy.deepcopy(conf), seed=2, device="cpu")
    conf["quantized_cells"] = True
    q = ASRBundle.from_config(conf, seed=2, device="cpu")
    want = plain.quantize().model.state_dict()
    for name, t in q.model.state_dict().items():
        assert torch.equal(t, want[name]), name
    assert q.model.encoder.rnn_stack.layer(1).cell.kernel.q.abs().max() == 127
