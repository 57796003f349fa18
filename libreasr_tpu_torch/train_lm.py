"""LM training CLI of the port (the repo's root train_lm.py): a text
corpus, tokenized with the char vocabulary or a BPE model, trains the
LSTM language model that shallow fusion serves (models/lm.py), with
cross-entropy on random crops, and reports the valid loss and
perplexity.

    python -m libreasr_tpu_torch.train_lm --corpus text.txt \\
        [--tokenizer tok.labpe] [--steps N] [--bs 768] [--seq-len 64] \\
        [--vocab-sz 2048] [--out lm.msgpack] [--device cuda]

As in JAX: each line is numericalized with <s> in front (fusion starts
the LM from it) and </s> at the end, the last 5% of the tokens are the
valid set, crops come from numpy generators seeded 0 (train) and 1
(valid), the LM has dropout 0.3, and the optimizer is
clip_by_global_norm(1.0) then adamw (weight decay 1e-4) on
warmup_cosine_decay_schedule(lr / 25, lr, steps // 10, steps), ending at
0. The model is float32 on the scan cells (no CUDA kernel of the port
runs); its weights come from a generator seeded 0 and its dropout masks
from one seeded 1 on the device, so they are not JAX's. `--out` is
written as flax serializes {"params": ...}: JAX's
serialization.from_bytes and the port's bundles (lm.msgpack) read it.
Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def batch_stream(ids, bs: int, seq_len: int, seed: int = 0):
    """Random crops of seq_len + 1 tokens -> (x, y) next-token pairs,
    [bs, seq_len] each, the starts drawn from numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    n = len(ids) - seq_len - 1
    while True:
        starts = rng.integers(0, n, bs)
        chunk = np.stack([ids[s: s + seq_len + 1] for s in starts])
        yield chunk[:, :-1], chunk[:, 1:]


def corpus_ids(path: str, lang) -> np.ndarray:
    """Every line's ids, <s> first and </s> last, concatenated (int32)."""
    ids = []
    with open(path) as f:
        for line in f:
            ids.extend(lang.numericalize(line.strip(), sos=True))
    return np.asarray(ids, np.int32)


def lm_optimizer(lr: float, steps: int):
    from .training.optimizers import (adam, chain, clip_by_global_norm,
                                      warmup_cosine_decay_schedule)

    schedule = warmup_cosine_decay_schedule(lr / 25, lr, max(steps // 10, 1), steps)
    return chain(clip_by_global_norm(1.0), adam(schedule, weight_decay=1e-4))


def nll(lm, x, y, generator=None):
    """Mean next-token negative log-likelihood of y given x."""
    logp, _ = lm(x, generator=generator)
    return -torch.gather(logp, -1, y[..., None].long())[..., 0].mean()


class LMTrainer:
    """The LM in training mode, its optimizer state and its dropout
    generator. `step(x, y)` is one optimizer step (`grads`, then
    `apply`) and returns the loss as a device tensor; `eval_loss(x, y)`
    the loss in eval mode."""

    def __init__(self, lm, tx, *, seed: int = 1):
        from .training.learner import TrainState

        self.lm = lm.train()
        self.tx = tx
        self.device = lm.embed.embedding.device
        self.params = list(lm.parameters())
        self.state = TrainState(step=0, opt_state=tx.init(
            [p.detach() for p in self.params]))
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def _tensors(self, x, y):
        return (torch.as_tensor(np.asarray(x), device=self.device).long(),
                torch.as_tensor(np.asarray(y), device=self.device).long())

    def grads(self, x, y):
        """(loss, the gradient of every parameter) of one batch."""
        x, y = self._tensors(x, y)
        loss = nll(self.lm, x, y, self.gen)
        return loss.detach(), list(torch.autograd.grad(loss, self.params))

    def apply(self, grads) -> None:
        from .training.learner import TrainState
        from .training.optimizers import apply_updates

        params = [p.detach() for p in self.params]
        updates, opt_state = self.tx.update(grads, self.state.opt_state, params)
        apply_updates(params, updates)
        self.state = TrainState(step=self.state.step + 1, opt_state=opt_state)

    def step(self, x, y) -> torch.Tensor:
        loss, grads = self.grads(x, y)
        self.apply(grads)
        return loss

    @torch.no_grad()
    def eval_loss(self, x, y) -> float:
        self.lm.eval()
        try:
            return float(nll(self.lm, *self._tensors(x, y)))
        finally:
            self.lm.train()


def save_lm(path: str, lm) -> str:
    from .checkpoint import msgpack_serialize
    from .convert import export_lm_variables

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack_serialize(export_lm_variables(lm)))
    return path


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--corpus", required=True)
    p.add_argument("--tokenizer", default="")
    p.add_argument("--bs", type=int, default=768)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--embed-sz", type=int, default=768)
    p.add_argument("--hidden-sz", type=int, default=768)
    p.add_argument("--num-layers", type=int, default=4)
    p.add_argument("--out", default="tmp/lm.msgpack")
    p.add_argument("--eval-every", type=int, default=200)
    p.add_argument("--vocab-sz", type=int, default=0,
                   help="pad the LM vocab (0 = tokenizer size); must match "
                        "the ASR model's padded vocab for fusion")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Trains and saves the LM. Returns {"trainer", "valid_losses" (each
    eval's), "out"}."""
    a = parse_args(argv)

    from . import resolve_device
    from .data.language import get_language
    from .models.lm import LM, LMConfig

    device = resolve_device(a.device)
    lang, vocab_sz = get_language(model_file=a.tokenizer or None)
    if a.vocab_sz:
        vocab_sz = max(vocab_sz, a.vocab_sz)
    print(f"[lm] vocab={vocab_sz}")

    ids = corpus_ids(a.corpus, lang)
    n_valid = max(len(ids) // 20, a.seq_len + 2)
    train_ids, valid_ids = ids[:-n_valid], ids[-n_valid:]
    print(f"[lm] corpus tokens: train={len(train_ids)} valid={len(valid_ids)}")

    cfg = LMConfig(vocab_sz=vocab_sz, embed_sz=a.embed_sz,
                   hidden_sz=a.hidden_sz, num_layers=a.num_layers, p=0.3)
    trainer = LMTrainer(LM(cfg, seed=0, device=device), lm_optimizer(a.lr, a.steps))
    stream = batch_stream(train_ids, a.bs, a.seq_len)
    v_stream = batch_stream(valid_ids, min(a.bs, 64), a.seq_len, seed=1)
    valid_losses = []
    t0 = time.time()
    for step in range(1, a.steps + 1):
        loss = trainer.step(*next(stream))
        if step % a.eval_every == 0 or step == a.steps:
            vl = trainer.eval_loss(*next(v_stream))
            valid_losses.append(vl)
            print(f"[lm] step {step} train_loss={float(loss):.3f} "
                  f"valid_loss={vl:.3f} ppl={np.exp(vl):.2f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    save_lm(a.out, trainer.lm)
    print(f"[lm] saved -> {a.out}")
    return {"trainer": trainer, "valid_losses": valid_losses, "out": a.out}


if __name__ == "__main__":
    main()
