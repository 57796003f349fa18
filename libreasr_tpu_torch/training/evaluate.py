"""Evaluation: greedy-decode batches of audio and score them against
their labels (the JAX package's training/evaluate.py, greedy only).

The model is the one being trained: it is put in eval mode for the
decode and back in training mode after, so its batch norms use their
running statistics and no dropout runs, as the JAX package's decode
does with its variables.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.decode import DecoderFns, greedy_decode
from ..ops.frontend import features_batch
from .metrics import cer, wer


@dataclass
class EvalResult:
    wer: float
    cer: float
    alignment_score: float
    n: int
    samples: list = field(default_factory=list)  # the first few, for the log


def evaluate(model, frontend, lang, batches, *,
             max_batches: int | None = None) -> EvalResult:
    """Decode `batches` (training Batches: pcm and label ids) with
    `model` on its device (greedy: 3 rounds a frame, 128 tokens, as the
    JAX package's eval step) and score them."""
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    fns = DecoderFns(predict_step=model.predict, joint_step=model.joint_step)
    wers, cers, aligns, samples = [], [], [], []
    try:
        for bi, batch in enumerate(batches):
            if max_batches is not None and bi >= max_batches:
                break
            with torch.inference_mode():
                feats, flens = features_batch(batch.audio.to(device),
                                              batch.audio_len.to(device),
                                              frontend)
                enc_out, _ = model.encode(feats, lengths=flens)
                toks, lens, metrics, _ = greedy_decode(
                    fns, enc_out, flens, blank=model.cfg.blank,
                    bos=model.cfg.bos, max_iters=3, max_tokens=128)
            toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
            align = metrics["alignment_score"].float().cpu().numpy()
            labels = batch.labels.numpy()
            for i in range(len(toks)):
                pred = lang.denumericalize(list(toks[i, : lens[i]]))
                target = lang.denumericalize(
                    list(labels[i, : int(batch.label_len[i])]))
                wers.append(wer(pred, target))
                cers.append(cer(pred, target))
                aligns.append(float(align[i]))
                if len(samples) < 8:
                    samples.append({"pred": pred, "target": target})
    finally:
        model.train(was_training)
    if not wers:
        return EvalResult(1.0, 1.0, 0.0, 0)
    return EvalResult(wer=float(np.mean(wers)), cer=float(np.mean(cers)),
                      alignment_score=float(np.mean(aligns)), n=len(wers),
                      samples=samples)
