"""Evaluation: decode batches of audio, greedy or with beam search, and
score them against their labels (the JAX package's
training/evaluate.py): WER, CER, the greedy alignment score, a few
samples, and the WER by utterance length.

As in JAX, the decode never fuses an LM (its eval binds the endpoints
with use_lm=False): greedy runs 3 rounds a frame and beam search
expands 3 times a frame, both up to 128 tokens; a beam's alignment
score is 0.

The model may be the one being trained: it is put in eval mode for the
decode and back in training mode after, so its batch norms use their
running statistics and no dropout runs, as the JAX package's decode
does with its variables.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.beam import beam_decode
from ..models.decode import DecoderFns, greedy_decode
from ..ops.frontend import features_batch
from .metrics import cer, wer

MAX_ITERS = 3
MAX_TOKENS = 128


@dataclass
class EvalResult:
    wer: float
    cer: float
    alignment_score: float
    n: int
    samples: list = field(default_factory=list)  # the first few, for the log
    by_length: dict = field(default_factory=dict)  # wer_by_length


def _decode(model, frontend, audio, audio_len, beam_width: int):
    """pcm -> (tokens, token counts, alignment scores) as numpy."""
    cfg = model.cfg
    fns = DecoderFns(predict_step=model.predict, joint_step=model.joint_step)
    feats, flens = features_batch(audio, audio_len, frontend)
    enc_out, _ = model.encode(feats, lengths=flens)
    if beam_width > 1:
        toks, lens, scores = beam_decode(
            fns, enc_out, flens, vocab_sz=cfg.vocab_sz, beam_width=beam_width,
            blank=cfg.blank, bos=cfg.bos, max_expand=MAX_ITERS,
            max_tokens=MAX_TOKENS)
        align = torch.zeros_like(scores)
    else:
        toks, lens, metrics, _ = greedy_decode(
            fns, enc_out, flens, vocab_sz=cfg.vocab_sz, blank=cfg.blank,
            bos=cfg.bos, max_iters=MAX_ITERS, max_tokens=MAX_TOKENS)
        align = metrics["alignment_score"]
    return toks.cpu().numpy(), lens.cpu().numpy(), align.float().cpu().numpy()


def evaluate(model, frontend, lang, batches, *, max_batches: int | None = None,
             keep_samples: int = 8, beam_width: int = 0) -> EvalResult:
    """Decode `batches` (training Batches: pcm and label ids) with `model`
    on its device and score them; beam_width > 1 runs beam search."""
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    wers, cers, aligns, samples, secs = [], [], [], [], []
    try:
        for bi, batch in enumerate(batches):
            if max_batches is not None and bi >= max_batches:
                break
            with torch.inference_mode():
                toks, lens, align = _decode(model, frontend, batch.audio.to(device),
                                            batch.audio_len.to(device), beam_width)
            labels = batch.labels.numpy()
            for i in range(len(toks)):
                pred = lang.denumericalize(list(toks[i, : lens[i]]))
                target = lang.denumericalize(
                    list(labels[i, : int(batch.label_len[i])]))
                wers.append(wer(pred, target))
                cers.append(cer(pred, target))
                aligns.append(float(align[i]))
                secs.append(float(batch.audio_len[i]) / frontend.sr)
                if len(samples) < keep_samples:
                    samples.append({"pred": pred, "target": target})
    finally:
        model.train(was_training)
    if not wers:
        return EvalResult(1.0, 1.0, 0.0, 0)
    return EvalResult(wer=float(np.mean(wers)), cer=float(np.mean(cers)),
                      alignment_score=float(np.mean(aligns)), n=len(wers),
                      samples=samples, by_length=wer_by_length(secs, wers))


def evaluate_bundle(bundle, batches, **kw) -> EvalResult:
    """`evaluate` with an ASRBundle's model, frontend and tokenizer (the
    JAX package's evaluate(bundle, batches, ...)); never its LM."""
    return evaluate(bundle.model, bundle.frontend, bundle.lang, batches, **kw)


def wer_by_length(secs, wers, edges=(2, 4, 6, 10, 20)) -> dict:
    """Mean WER by utterance duration: {"0-2s": {"wer", "n"}, ...,
    ">20s": ...}, buckets [lo, hi) with no member left out."""
    out = {}
    lo = 0.0
    for hi in list(edges) + [float("inf")]:
        sel = [w for s, w in zip(secs, wers) if lo <= s < hi]
        if sel:
            label = f"{lo:g}-{hi:g}s" if hi != float("inf") else f">{lo:g}s"
            out[label] = {"wer": float(np.mean(sel)), "n": len(sel)}
        lo = hi
    return out
