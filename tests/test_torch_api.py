"""The port's offline API on the CPU: exact golden transcripts, and the
same token ids and alignment scores as the JAX package's
transcribe_batch program on the same bundle and audio, for the char
and the BPE golden bundles.

At 1 s the golden clips give T = 12 encoder frames (scan path on both
sides). Zero-padded to 3 s with the true lengths they give T = 37, and
the encoder runs the bf16-R sequence recurrence: the port's kernel
twin, and JAX's Pallas kernel in interpret mode (LIBREASR_FORCE_PALLAS).
"""

import os

import numpy as np
import pytest

from libreasr_tpu.api import ASRBundle as JaxBundle
from libreasr_tpu_torch.api import ASRBundle
from libreasr_tpu_torch.data.audio import read_wav

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
TEXTS = [
    "yes", "no", "hello world", "stop now",
    "go left", "turn right", "one two", "three four",
]


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    path = os.path.join(FIXTURES, "model.tar.gz")
    tb = ASRBundle.from_bundle(path, extract_to=str(tmp_path_factory.mktemp("t")),
                               device="cpu")
    jb = JaxBundle.from_bundle(path, extract_to=str(tmp_path_factory.mktemp("j")))
    audio = np.zeros((8, 16000), np.float32)
    for i in range(8):
        pcm, _ = read_wav(os.path.join(FIXTURES, f"s-{i:03d}.wav"))
        audio[i] = pcm[0]
    return tb, jb, audio


@pytest.mark.parametrize("samples", [16000, 48000])
def test_golden_exact_and_tokens_match_jax(golden, samples, monkeypatch):
    monkeypatch.setenv("LIBREASR_FORCE_PALLAS", "1")
    tb, jb, audio = golden
    padded = np.zeros((8, samples), np.float32)
    padded[:, :16000] = audio
    lengths = np.full(8, 16000)
    texts, metrics = tb.transcribe_batch(padded, lengths)
    assert texts == TEXTS
    toks, tok_lens, _ = tb.decode_tokens(padded, lengths)
    run = jb._decode_program(False, 3, 256)
    jtoks, jlens, jmetrics = run(jb.variables, None, padded, lengths)
    np.testing.assert_array_equal(tok_lens, np.asarray(jlens))
    np.testing.assert_array_equal(toks, np.asarray(jtoks))
    np.testing.assert_allclose(metrics["alignment_score"],
                               np.asarray(jmetrics["alignment_score"]), rtol=1e-6)


def test_transcribe_single_and_int16(golden):
    tb, _, audio = golden
    text, metrics = tb.transcribe(audio[2])
    assert text == "hello world"
    assert 0.0 < float(metrics["alignment_score"]) <= 1.0
    pcm16 = np.round(audio * 32768.0).clip(-32768, 32767).astype(np.int16)
    texts, _ = tb.transcribe_batch(pcm16, np.full(8, 16000))
    assert texts == TEXTS


@pytest.mark.parametrize("samples", [16000, 48000])
def test_bpe_bundle_exact_and_tokens_match_jax(golden, samples, tmp_path,
                                               monkeypatch):
    monkeypatch.setenv("LIBREASR_FORCE_PALLAS", "1")
    _, _, audio = golden
    path = os.path.join(FIXTURES, "model_bpe.tar.gz")
    tb = ASRBundle.from_bundle(path, extract_to=str(tmp_path / "t"), device="cpu")
    jb = JaxBundle.from_bundle(path, extract_to=str(tmp_path / "j"))
    padded = np.zeros((8, samples), np.float32)
    padded[:, :16000] = audio
    lengths = np.full(8, 16000)
    texts, _ = tb.transcribe_batch(padded, lengths)
    assert texts == TEXTS
    toks, tok_lens, _ = tb.decode_tokens(padded, lengths)
    jtoks, jlens, _ = jb._decode_program(False, 3, 256)(
        jb.variables, None, padded, lengths)
    np.testing.assert_array_equal(tok_lens, np.asarray(jlens))
    np.testing.assert_array_equal(toks, np.asarray(jtoks))


def test_from_config_padding_invariance():
    from libreasr_tpu_torch.config import apply_overrides, open_config

    conf = apply_overrides(open_config(), ["inference"])
    conf["model"].update(embed_sz=16, hidden_sz=24, out_sz=24, joint_sz=16,
                         vocab_sz=40)
    conf["model"]["encoder"]["num_layers"] = 2
    conf["model"]["predictor"]["num_layers"] = 1
    conf["dtypes"]["compute"] = "float32"
    bundle = ASRBundle.from_config(conf, seed=1, device="cpu")
    rng = np.random.default_rng(0)
    a = rng.standard_normal(16000).astype(np.float32) * 0.1
    b = rng.standard_normal(8000).astype(np.float32) * 0.1
    batch = np.zeros((2, 16000), np.float32)
    batch[0], batch[1, :8000] = a, b
    texts, metrics = bundle.transcribe_batch(batch, np.array([16000, 8000]))
    assert texts[1] == bundle.transcribe(b)[0]
    assert texts[0] == bundle.transcribe(a)[0]
    assert ((metrics["alignment_score"] >= 0) & (metrics["alignment_score"] <= 1)).all()


@pytest.mark.parametrize("kw", [{}, {"use_lm": False}], ids=["default", "no_lm"])
def test_bpe_decoder_fns_default_matches_jax(golden, kw, tmp_path):
    """decoder_fns() binds the bundle's LM by default, as JAX's does: on
    the golden BPE bundle (which has an LM) a greedy decode through the
    default endpoints fuses the LM on both sides, tokens exact; with
    use_lm=False neither side fuses."""
    import jax.numpy as jnp

    from libreasr_tpu.models.decode import greedy_decode as jax_greedy
    from libreasr_tpu.ops.frontend import features_batch as jax_features
    from libreasr_tpu_torch.models.decode import greedy_decode

    _, _, audio = golden
    path = os.path.join(FIXTURES, "model_bpe.tar.gz")
    tb = ASRBundle.from_bundle(path, extract_to=str(tmp_path / "t"), device="cpu")
    jb = JaxBundle.from_bundle(path, extract_to=str(tmp_path / "j"))
    assert tb.lm is not None and jb.lm is not None
    lengths = np.full(8, 16000)
    fns = tb.decoder_fns(**kw)
    assert (fns.lm_step is not None) == (kw.get("use_lm", True))
    enc, flens = tb._encode_audio(audio, lengths)
    toks, tok_lens, _, _ = greedy_decode(
        fns, enc, flens, vocab_sz=tb.cfg.vocab_sz, blank=tb.cfg.blank,
        bos=tb.cfg.bos, max_iters=3, max_tokens=64)
    feats, jflens = jax_features(jnp.asarray(audio), jnp.asarray(lengths),
                                 jb.frontend)
    jenc, _ = jb.encode(feats, jflens)
    jtoks, jlens, _, _ = jax_greedy(
        jb.decoder_fns(**kw), jenc, jflens, vocab_sz=jb.cfg.vocab_sz,
        blank=jb.cfg.blank, bos=jb.cfg.bos, max_iters=3, max_tokens=64)
    np.testing.assert_array_equal(tok_lens.numpy(), np.asarray(jlens))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
