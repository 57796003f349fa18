"""The port's importers of the reference LibreASR (libreasr_tpu_torch/compat,
scripts/import_reference.py) against the JAX package's.

- convert_*: the port's copy and JAX's give equal arrays on the same
  reference-layout state_dict (tests/test_torch_import.py's
  make_reference_state_dict), and the port's forward on the converted
  weights agrees with JAX's forward on them;
- youtokentome: a model written, parsed and converted by both packages
  gives the same bytes, LABPE1 included, and the same refusal of
  non-default special ids;
- a synthetic release archive ({lang}/model.pth, {lang}/tokenizer.
  yttm-model) through JAX's import_reference_archive and the port's
  script: the same config, np.array_equal parameters, the same
  tokenizer bytes, the same transcripts from both bundles on the CPU.

Tolerances: the forwards 1e-5 relative and 1e-5 absolute (float32 on
both sides, sums in another order); everything else exact.
"""

import os
import sys
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from libreasr_tpu.compat import torch_import as jti
from libreasr_tpu.compat import yttm_import as jyi
from libreasr_tpu.models.transducer import TransducerConfig as JaxConfig
from libreasr_tpu.models.transducer import init_transducer
from libreasr_tpu_torch.compat import torch_import as tti
from libreasr_tpu_torch.compat import yttm_import as tyi
from libreasr_tpu_torch.convert import flatten_variables, load_jax_variables
from libreasr_tpu_torch.models.transducer import Transducer, TransducerConfig
from libreasr_tpu_torch.scripts import import_reference as tir
from test_torch_import import make_reference_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHABET = "▁abcdehlorstwn"
MERGES = [("h", "e"), ("▁", "he"), ("l", "l"), ("o", "r"), ("s", "t")]
VOCAB = 4 + len(ALPHABET) + len(MERGES)
SHAPES = dict(feature_sz=1280, embed_sz=5, vocab_sz=VOCAB, hidden_sz=16,
              out_sz=16, joint_sz=12, enc_num_layers=2, pred_num_layers=1)


@pytest.mark.parametrize("fn", ["transducer", "lstm", "gru", "lm"])
def test_converters_equal_jax(rng, fn):
    cfg = JaxConfig(**{**SHAPES, "feature_sz": 6})
    sd = make_reference_state_dict(rng, cfg)
    if fn == "transducer":
        got, want = tti.convert_transducer(sd, cfg), jti.convert_transducer(sd, cfg)
    elif fn == "lstm":
        got = tti.convert_torch_lstm(sd, "encoder.rnn_stack.rnns.1")
        want = jti.convert_torch_lstm(sd, "encoder.rnn_stack.rnns.1")
    elif fn == "gru":
        got = tti.convert_haste_gru(sd, "predictor.rnn_stack.rnns.0")
        want = jti.convert_haste_gru(sd, "predictor.rnn_stack.rnns.0")
    else:
        lm = torch.nn.LSTM(8, 8, num_layers=2)
        lsd = {f"rnn.{k}": v.detach().numpy() for k, v in lm.state_dict().items()}
        lsd["embed.weight"] = rng.standard_normal((VOCAB, 8)).astype(np.float32)
        lsd["linear.weight"] = rng.standard_normal((VOCAB, 8)).astype(np.float32)
        lsd["linear.bias"] = np.zeros(VOCAB, np.float32)
        got, want = tti.convert_lm(lsd, 2), jti.convert_lm(lsd, 2)
    fg, fw = flatten_variables(got), flatten_variables(want)
    assert set(fg) == set(fw) and fg
    for k in fw:
        assert fg[k].dtype == fw[k].dtype and np.array_equal(fg[k], fw[k]), k


def test_port_forward_on_converted_weights_equals_jax(rng):
    cfg = JaxConfig(**{**SHAPES, "feature_sz": 6})
    sd = make_reference_state_dict(rng, cfg)
    jmodel, template = init_transducer(cfg, jax.random.PRNGKey(0))
    jvars = serialization.from_state_dict(template, jti.convert_transducer(sd, cfg))
    model = Transducer(TransducerConfig(**{**SHAPES, "feature_sz": 6}))
    load_jax_variables(model, tti.convert_transducer(sd, cfg))
    x = rng.standard_normal((2, 5, 6)).astype(np.float32)
    y = rng.integers(1, VOCAB, (2, 3)).astype(np.int32)
    want, _ = jmodel.apply(jvars, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        got, _ = model(torch.from_numpy(x), torch.from_numpy(y).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_yttm_files_bytes_equal_jax(tmp_path):
    for pkg, name in ((jyi, "j"), (tyi, "t")):
        pkg.write_yttm_model(str(tmp_path / f"{name}.yttm"), ALPHABET, MERGES)
    yt = (tmp_path / "t.yttm").read_bytes()
    assert yt == (tmp_path / "j.yttm").read_bytes()
    assert tyi.parse_yttm_model(str(tmp_path / "t.yttm")) == \
        jyi.parse_yttm_model(str(tmp_path / "t.yttm"))
    vt = tyi.convert_yttm_model(str(tmp_path / "t.yttm"), str(tmp_path / "t.labpe"))
    vj = jyi.convert_yttm_model(str(tmp_path / "t.yttm"), str(tmp_path / "j.labpe"))
    assert vt == vj == VOCAB
    assert (tmp_path / "t.labpe").read_bytes() == (tmp_path / "j.labpe").read_bytes()
    bad = tmp_path / "bad.yttm"
    bad.write_text(yt.decode().rsplit("\n", 2)[0] + "\n0 1 2 3\n")
    for pkg in (tyi, jyi):
        with pytest.raises(ValueError, match="special ids"):
            pkg.convert_yttm_model(str(bad), str(tmp_path / "x.labpe"))


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """A reference release archive: a state_dict at SHAPES (the blank
    logit lowered so the random model emits) and a yttm tokenizer."""
    rng = np.random.default_rng(3)
    sd = make_reference_state_dict(rng, JaxConfig(**SHAPES))
    sd["joint.joint.2.bias"][0] -= 3.0
    tmp = tmp_path_factory.mktemp("refbundle")
    d = tmp / "en"
    d.mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, d / "model.pth")
    tyi.write_yttm_model(str(d / "tokenizer.yttm-model"), ALPHABET, MERGES)
    path = tmp / "libreasr-model-en.tar.gz"
    with tarfile.open(path, "w:gz") as tar:
        tar.add(d, arcname="en")
    return str(path)


def test_import_archive_equals_jax_and_transcribes_alike(archive, tmp_path):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from import_reference import import_reference_archive

    from libreasr_tpu.api import ASRBundle as JaxBundle
    from libreasr_tpu.training.checkpoint import load_bundle as jax_load_bundle
    from libreasr_tpu_torch.api import ASRBundle
    from libreasr_tpu_torch.checkpoint import load_bundle

    base = os.path.join(REPO, "config", "base.yaml")
    jout, tout = str(tmp_path / "j.tar.gz"), str(tmp_path / "t.tar.gz")
    import_reference_archive(archive, "en", jout, base_config=base)
    tir.main(["--archive", archive, "--out", tout, "--config", base,
              "--device", "cpu"])

    tvars, ttok, _, tconf = load_bundle(tout, "en", str(tmp_path / "xt"))
    jvars, jtok, _, jconf = load_bundle(jout, "en", str(tmp_path / "xj"))
    assert tconf == jconf
    assert tconf["model"]["vocab_sz"] == VOCAB
    assert open(ttok, "rb").read() == open(jtok, "rb").read()
    ft, fj = flatten_variables(tvars), flatten_variables(jvars)
    assert set(ft) == set(fj)
    for k in fj:
        assert np.array_equal(ft[k], fj[k]), k
    # JAX's loader takes the port's bundle
    _, template = init_transducer(JaxConfig.from_config(tconf), jax.random.PRNGKey(0))
    jax_load_bundle(tout, "en", template, extract_to=str(tmp_path / "xjt"))

    audio = (np.random.default_rng(4).standard_normal((3, 16000)) * 0.1
             ).astype(np.float32)
    lens = np.array([16000, 12000, 9000])
    tb = ASRBundle.from_bundle(tout, extract_to=str(tmp_path / "yt"), device="cpu")
    jb = JaxBundle.from_bundle(jout, lang_name="en", extract_to=str(tmp_path / "yj"))
    want, _ = jb.transcribe_batch(audio, lens)
    toks, n, _ = tb.decode_tokens(audio, lens)
    assert [jb.lang.denumericalize(list(t[:k])) for t, k in zip(toks, n)] == want
    assert all(n) and any(w.strip() for w in want)
    # the port's BPE text is stripped at both ends, as the JAX package's
    # Python decoder strips it (its native decoder keeps a trailing space)
    got, _ = tb.transcribe_batch(audio, lens)
    assert got == [w.strip() for w in want]


def test_import_defaults_to_cuda(archive, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tir.main(["--archive", archive, "--out", str(tmp_path / "x.tar.gz")])
    assert not (tmp_path / "x.tar.gz").exists()
