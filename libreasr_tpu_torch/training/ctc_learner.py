"""CTC model family training (the JAX package's training/ctc_learner.py).

One step is

    device frontend with SpecAugment -> CTCModel (dropout) -> CTC loss,
    the mean over the batch -> gradients -> optimizer,

with the JAX step's finite gate: a non-finite loss zeroes every
gradient, and the optimizer still steps. `evaluate` decodes greedily
and scores WER and CER. The batches, bucketing and frontend are the
transducer's. SpecAugment and dropout draw from one generator on the
device, seeded from `seed`; they cannot give jax.random's bits, so
parity with JAX holds with dropout 0 and augmentation off. The step
launches none of the port's CUDA kernels: attention, the feed-forward
layers and the loss's recursion are plain torch ops.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.ctc import CTCModel, ctc_decode_greedy, ctc_loss
from ..ops.frontend import FrontendConfig, features_batch
from .learner import Batch, TrainState
from .metrics import cer, wer
from .optimizers import Transform, apply_updates, global_norm


class CTCLearner:
    """Owns the model in training mode, the optimizer state and the
    generator. `step(batch)` runs one train step and returns its metrics
    as device tensors."""

    def __init__(self, model: CTCModel, tx: Transform,
                 frontend: FrontendConfig | None = None, *, seed: int = 0):
        self.model = model.train()
        self.cfg = model.cfg
        self.device = next(model.parameters()).device
        self.tx = tx
        self.frontend = frontend
        self.params = list(model.parameters())
        self.state = TrainState(step=0, opt_state=tx.init(
            [p.detach() for p in self.params]))
        self.gen = torch.Generator(device=self.device).manual_seed(seed + 1)

    def features(self, batch: Batch):
        if self.frontend is None:
            return batch.audio, batch.audio_len
        return features_batch(batch.audio, batch.audio_len, self.frontend,
                              augment=True, generator=self.gen)

    def loss(self, feats, flens, batch: Batch):
        logp = self.model(feats, flens, generator=self.gen)
        return ctc_loss(logp, batch.labels, flens, batch.label_len,
                        self.cfg.blank).mean()

    def backward(self, loss):
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, self.params)]
        finite = torch.isfinite(loss)
        return [torch.where(finite, g, torch.zeros_like(g)) for g in grads], finite

    def optimize(self, grads) -> None:
        params = [p.detach() for p in self.params]
        updates, opt_state = self.tx.update(grads, self.state.opt_state, params)
        apply_updates(params, updates)
        self.state = TrainState(step=self.state.step + 1, opt_state=opt_state)

    def step(self, batch: Batch) -> dict:
        batch = Batch(*(x.to(self.device) for x in batch))
        feats, flens = self.features(batch)
        loss = self.loss(feats, flens, batch)
        grads, finite = self.backward(loss)
        self.optimize(grads)
        return {"loss": loss.detach(), "finite": finite,
                "grad_norm": global_norm(grads)}

    @torch.no_grad()
    def decode(self, audio, audio_len):
        """Greedy CTC tokens and counts of a batch of pcm (or features),
        with the model in eval mode (and back in training mode after)."""
        self.model.eval()
        try:
            audio, audio_len = audio.to(self.device), audio_len.to(self.device)
            if self.frontend is not None:
                feats, flens = features_batch(audio, audio_len, self.frontend)
            else:
                feats, flens = audio, audio_len
            logp = self.model(feats, flens)
            return ctc_decode_greedy(logp, flens, self.cfg.blank)
        finally:
            self.model.train()

    def evaluate(self, batches, lang, max_batches=None) -> dict:
        """Mean WER and CER over the rows of up to `max_batches` batches
        (1.0 each when there is none), and the number of rows (at least 1)."""
        wers, cers = [], []
        for bi, b in enumerate(batches):
            if max_batches is not None and bi >= max_batches:
                break
            toks, lens = self.decode(b.audio, b.audio_len)
            toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
            labels, label_len = b.labels.cpu().numpy(), b.label_len.cpu().numpy()
            for i in range(len(toks)):
                pred = lang.denumericalize(list(toks[i, : lens[i]]))
                tgt = lang.denumericalize(list(labels[i, : label_len[i]]))
                wers.append(wer(pred, tgt))
                cers.append(cer(pred, tgt))
        return {"wer": float(np.mean(wers or [1.0])),
                "cer": float(np.mean(cers or [1.0])), "n": max(len(wers), 1)}
