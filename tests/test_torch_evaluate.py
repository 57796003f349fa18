"""The port's evaluation (libreasr_tpu_torch/training/evaluate.py) against
the JAX package's `evaluate` on the golden bundles: two batches of the
tone test split in one 3 s bucket (padded T 37, so the encoder runs the
sequence recurrence: the port's kernel twin, JAX's Pallas kernel in
interpret mode), greedy and beam search (K 3); WER, CER, n, the samples
and the WER by length exact. Also `wer_by_length` on every edge.

The tone recipe's own shape, V 2048 with a 64-token tokenizer (1,984
ids that no label ever trains), on a model that the port's recipe
trained on the CPU (tests/fixtures/tone_v2048, its README says how):
`evaluate` greedy and with beam search (K 4) exact against JAX's on 64
test utterances, and `beam_decode` on the same encoder output against
JAX's: tokens and lengths exact, scores within BEAM_SCORE_TOL (as
tests/test_beam.py:105 holds its oracle; the sums of float32 log-probs
run in another order)."""

import os

import numpy as np
import pytest
import torch

from libreasr_tpu_torch.api import ASRBundle
from libreasr_tpu_torch.data.synth import ToneStreamDataset
from libreasr_tpu_torch.training.evaluate import (EvalResult, evaluate,
                                                  evaluate_bundle, wer_by_length)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
CONF = {"synth_tone": {"enabled": True, "hours_per_epoch": 0.01, "speakers": 4,
                       "heldout_speakers": 2, "eval_utts": 16, "seed": 7},
        "num_workers": 2,
        "buckets": [{"max_samples": 48000, "y_max": 64, "bs": 4}]}


@pytest.fixture(scope="module", params=["model.tar.gz", "model_bpe.tar.gz"],
                ids=["char", "bpe"])
def bundles(request, tmp_path_factory):
    from libreasr_tpu.api import ASRBundle as JaxBundle

    path = os.path.join(FIXTURES, request.param)
    d = tmp_path_factory.mktemp("eval")
    return (ASRBundle.from_bundle(path, extract_to=str(d / "t"), device="cpu"),
            JaxBundle.from_bundle(path, extract_to=str(d / "j")))


@pytest.mark.parametrize("beam_width", [0, 3], ids=["greedy", "beam3"])
def test_evaluate_matches_jax(bundles, beam_width, monkeypatch):
    from libreasr_tpu.data.synth import ToneStreamDataset as JaxTone
    from libreasr_tpu.training.evaluate import evaluate as jax_evaluate

    monkeypatch.setenv("LIBREASR_FORCE_PALLAS", "1")
    tb, jb = bundles
    ds = ToneStreamDataset.from_config(CONF, tb.lang, "test")
    jds = JaxTone.from_config(CONF, jb.lang, "test")
    got = evaluate_bundle(tb, iter(ds), max_batches=2, beam_width=beam_width)
    want = jax_evaluate(jb, iter(jds), max_batches=2, beam_width=beam_width)
    assert got.n == want.n == 8
    assert (got.wer, got.cer) == (want.wer, want.cer)
    assert got.samples == want.samples and len(got.samples) == 8
    assert got.by_length == want.by_length and sum(
        r["n"] for r in got.by_length.values()) == 8
    if beam_width:
        assert got.alignment_score == want.alignment_score == 0.0
    else:
        assert got.alignment_score == pytest.approx(want.alignment_score, rel=1e-6)


def test_wer_by_length_matches_jax():
    from libreasr_tpu.training.evaluate import wer_by_length as jax_by_length

    secs = [0.0, 1.99, 2.0, 3.5, 3.999, 4.0, 5.0, 6.0, 9.99, 10.0, 19.5, 20.0, 41.0]
    wers = [0.0, 1.0, 0.5, 0.25, 0.125, 2.0, 0.0, 1.0, 0.3, 0.7, 0.1, 0.9, 1.5]
    for edges in [(2, 4, 6, 10, 20), (1, 3), ()]:
        got = wer_by_length(secs, wers, edges)
        assert got == jax_by_length(secs, wers, edges)
        assert sum(r["n"] for r in got.values()) == len(secs)
    assert list(wer_by_length(secs, wers)) == [
        "0-2s", "2-4s", "4-6s", "6-10s", "10-20s", ">20s"]
    assert wer_by_length([3.0], [0.5]) == {"2-4s": {"wer": 0.5, "n": 1}}
    assert wer_by_length([], []) == {}


def test_evaluate_keeps_samples_restores_mode_and_scores_nothing(bundles):
    tb, _ = bundles
    ds = ToneStreamDataset.from_config(CONF, tb.lang, "test")
    model = tb.model.train()
    try:
        res = evaluate(model, tb.frontend, tb.lang, iter(ds), max_batches=1,
                       keep_samples=2)
        assert model.training
    finally:
        model.eval()
    assert res.n == 4 and len(res.samples) == 2 and res.by_length
    assert evaluate(model, tb.frontend, tb.lang, iter([])) == EvalResult(1.0, 1.0, 0.0, 0)


V2048 = os.path.join(os.path.dirname(__file__), "fixtures", "tone_v2048", "model.tar.gz")
V2048_CONF = {"synth_tone": {"enabled": True, "hours_per_epoch": 0.01, "speakers": 16,
                             "heldout_speakers": 4, "eval_utts": 64, "seed": 42},
              "num_workers": 2,
              "buckets": [{"max_samples": 48000, "y_max": 64, "bs": 8}]}
BEAM_SCORE_TOL = 1e-4


@pytest.fixture(scope="module")
def v2048(tmp_path_factory):
    from libreasr_tpu.api import ASRBundle as JaxBundle

    d = tmp_path_factory.mktemp("v2048")
    tb = ASRBundle.from_bundle(V2048, extract_to=str(d / "t"), device="cpu")
    assert (len(tb.lang), tb.cfg.vocab_sz) == (64, 2048)
    return tb, JaxBundle.from_bundle(V2048, extract_to=str(d / "j"))


@pytest.mark.parametrize("beam_width", [0, 4], ids=["greedy", "beam4"])
def test_evaluate_matches_jax_on_trained_v2048_bundle(v2048, beam_width):
    from libreasr_tpu.data.synth import ToneStreamDataset as JaxTone
    from libreasr_tpu.training.evaluate import evaluate as jax_evaluate

    tb, jb = v2048
    got = evaluate_bundle(tb, iter(ToneStreamDataset.from_config(V2048_CONF, tb.lang, "test")),
                          beam_width=beam_width, keep_samples=64)
    want = jax_evaluate(jb, iter(JaxTone.from_config(V2048_CONF, jb.lang, "test")),
                        beam_width=beam_width, keep_samples=64)
    assert got.n == want.n == 64
    assert (got.wer, got.cer) == (want.wer, want.cer)
    assert got.samples == want.samples and got.by_length == want.by_length
    assert 0.0 < got.wer < 1.0  # the model emits, and not every word is right
    print(f"v2048 beam_width={beam_width}: wer={got.wer} cer={got.cer} n={got.n}")


def test_beam_decode_matches_jax_on_trained_v2048_bundle(v2048):
    import jax.numpy as jnp

    from libreasr_tpu.models.beam import beam_decode as jax_beam_decode
    from libreasr_tpu_torch.models.beam import beam_decode
    from libreasr_tpu_torch.models.decode import greedy_decode
    from libreasr_tpu_torch.ops.frontend import features_batch

    tb, jb = v2048
    cfg = tb.cfg
    kw = dict(vocab_sz=cfg.vocab_sz, beam_width=4, blank=cfg.blank, bos=cfg.bos,
              max_expand=3, max_tokens=128)
    gap, eos_last = 0.0, {"beam": 0, "greedy": 0}
    for batch in ToneStreamDataset.from_config(V2048_CONF, tb.lang, "test"):
        with torch.inference_mode():
            feats, flens = features_batch(batch.audio, batch.audio_len, tb.frontend)
            enc, _ = tb.model.encode(feats, lengths=flens)
            fns = tb.decoder_fns(use_lm=False)
            toks, lens, scores = beam_decode(fns, enc, flens, **kw)
            gtoks, glens, _, _ = greedy_decode(
                fns, enc, flens, vocab_sz=cfg.vocab_sz, blank=cfg.blank,
                bos=cfg.bos, max_iters=3, max_tokens=128)
        jt, jl, js = jax_beam_decode(jb.decoder_fns(use_lm=False),
                                     jnp.asarray(enc.numpy()),
                                     jnp.asarray(flens.numpy()), **kw)
        np.testing.assert_array_equal(lens.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
        np.testing.assert_allclose(scores.numpy(), np.asarray(js), rtol=0,
                                   atol=BEAM_SCORE_TOL)
        gap = max(gap, float(np.abs(scores.numpy() - np.asarray(js)).max()))
        emitted = np.concatenate([toks[i, : lens[i]].numpy() for i in range(len(lens))])
        # every hypothesis emits, and only ids that the tokenizer spells
        assert lens.min() > 0 and emitted.max() < len(tb.lang)
        # hypotheses whose last token is EOS (the text stops there)
        for name, (t, n) in (("beam", (toks, lens)), ("greedy", (gtoks, glens))):
            eos_last[name] += sum(int(t[i, n[i] - 1]) == tb.lang.eos
                                            for i in range(len(n)) if n[i] > 0)
    print(f"v2048 beam_decode: largest score gap {gap}; rows ending in EOS {eos_last}")
