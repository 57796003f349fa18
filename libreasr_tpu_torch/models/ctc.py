"""CTC model family (the JAX package's models/ctc.py): a pre-LN
transformer encoder over the stacked features, a vocabulary projection
and log_softmax, trained with the CTC loss and decoded greedily.

    features [N, T, F] -> in_proj (only when F != d_model) -> + sinusoidal
    positions -> n_layers x (LN -> self-attention -> dropout -> +;
    LN -> Dense(4d) -> gelu -> Dense(d) -> dropout -> +) -> LN -> out

The numerics are flax's, so that a JAX model carried across
(convert.load_jax_ctc_variables) gives the same log-probs:
- attention as nn.MultiHeadDotProductAttention: the query scaled by
  1/sqrt(head_dim) before the product, masked logits set to float32's
  lowest value (a padded query row, every key masked, is uniform over
  all T keys; scaled_dot_product_attention would give NaN there),
  softmax in float32, dropout on the weights with one mask for every
  row and head; parameters `query`/`key`/`value` kernels [d, heads,
  head_dim] with biases [heads, head_dim], and `out` [heads, head_dim, d];
- LayerNorm epsilon 1e-6, gelu in its tanh approximation;
- the loss is optax.ctc_loss's alpha recursion, with impossible paths at
  log_epsilon = -1e5 rather than -inf: an utterance with more labels
  than its frames allow has a finite loss of about 1e5 (torch's
  ctc_loss with zero_infinity gives 0 there).

Submodules are named as flax names them (`block{i}.LayerNorm_0`,
`block{i}.MultiHeadDotProductAttention_0.query.kernel`, ...), so the
flax variable tree maps 1:1. No TPU kernel is involved, in JAX as here:
every op is a plain torch op.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .modules import Dense, LayerNorm, _lecun_normal, dropout

# optax.ctc_loss's stand-in for log(0)
LOG_EPSILON = -1e5


@dataclass(frozen=True)
class CTCConfig:
    feature_sz: int = 128
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 8
    ffn_mult: int = 4
    vocab_sz: int = 2048
    dropout: float = 0.1
    blank: int = 0

    @classmethod
    def from_config(cls, conf: dict) -> "CTCConfig":
        m = conf.get("model", {})
        ctc = m.get("ctc", {}) or {}
        return cls(
            feature_sz=m.get("feature_sz", 128),
            vocab_sz=m.get("vocab_sz", 2048),
            d_model=ctc.get("d_model", 128),
            n_heads=ctc.get("n_heads", 8),
            n_layers=ctc.get("n_layers", 8),
            dropout=ctc.get("dropout", 0.1),
        )


class _HeadsDense(nn.Module):
    """flax DenseGeneral d -> [heads, head_dim]."""

    def __init__(self, d, heads, head_dim, gen):
        super().__init__()
        self.kernel = nn.Parameter(
            _lecun_normal((d, heads * head_dim), gen).reshape(d, heads, head_dim))
        self.bias = nn.Parameter(torch.zeros(heads, head_dim))

    def forward(self, x):
        return torch.einsum("ntd,dhk->nthk", x, self.kernel) + self.bias


class _OutDense(nn.Module):
    """flax DenseGeneral [heads, head_dim] -> d."""

    def __init__(self, heads, head_dim, d, gen):
        super().__init__()
        self.kernel = nn.Parameter(
            _lecun_normal((heads * head_dim, d), gen).reshape(heads, head_dim, d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return torch.einsum("nthk,hkd->ntd", x, self.kernel) + self.bias


class MultiHeadAttention(nn.Module):
    """Self-attention with flax's MultiHeadDotProductAttention numerics."""

    def __init__(self, d, heads, rate, gen):
        super().__init__()
        if d % heads:
            raise ValueError(f"d_model {d} is not a multiple of {heads} heads")
        self.heads, self.head_dim, self.rate = heads, d // heads, rate
        self.query = _HeadsDense(d, heads, self.head_dim, gen)
        self.key = _HeadsDense(d, heads, self.head_dim, gen)
        self.value = _HeadsDense(d, heads, self.head_dim, gen)
        self.out = _OutDense(heads, self.head_dim, d, gen)

    def forward(self, x, mask=None, generator=None):
        q = self.query(x) / math.sqrt(self.head_dim)
        k, v = self.key(x), self.value(x)
        logits = torch.einsum("nqhd,nkhd->nhqk", q, k)
        if mask is not None:
            logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, dim=-1)
        if self.training and self.rate > 0.0:
            keep_prob = 1.0 - self.rate
            t = w.shape[-1]
            keep = torch.rand((1, 1, t, t), generator=generator,
                              device=generator.device).to(w.device) < keep_prob
            w = w * (keep.to(w.dtype) / keep_prob)
        return self.out(torch.einsum("nhqk,nkhd->nqhd", w, v))


class TransformerBlock(nn.Module):
    def __init__(self, d, heads, ffn_mult, rate, gen):
        super().__init__()
        self.rate = rate
        self.LayerNorm_0 = LayerNorm(d)
        self.MultiHeadDotProductAttention_0 = MultiHeadAttention(d, heads, rate, gen)
        self.LayerNorm_1 = LayerNorm(d)
        self.Dense_0 = Dense(d, d * ffn_mult, gen)
        self.Dense_1 = Dense(d * ffn_mult, d, gen)

    def _drop(self, x, generator):
        return dropout(x, self.rate, generator) if self.training else x

    def forward(self, x, mask=None, generator=None):
        h = self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x), mask, generator)
        x = x + self._drop(h, generator)
        h = self.Dense_1(F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh"))
        return x + self._drop(h, generator)


@lru_cache(maxsize=16)
def _positions(t: int, d: int) -> np.ndarray:
    """Sinusoidal positions [T, d] float32, computed as JAX does (float64
    on the host, then cast)."""
    pos = np.arange(t)[:, None] / np.power(10000.0, np.arange(0, d, 2) / d)
    pe = np.zeros((t, d), np.float32)
    pe[:, 0::2] = np.sin(pos)
    pe[:, 1::2] = np.cos(pos)
    return pe


class CTCModel(nn.Module):
    """Weights are drawn from a CPU torch.Generator seeded with `seed`
    and then moved to `device`. Starts in eval mode; in training mode
    the residual and attention dropout draw from the generator passed
    to forward."""

    def __init__(self, cfg: CTCConfig, *, seed: int = 0, device=None):
        super().__init__()
        self.cfg = c = cfg
        gen = torch.Generator().manual_seed(seed)
        self.in_proj = (Dense(c.feature_sz, c.d_model, gen)
                        if c.feature_sz != c.d_model else None)
        for i in range(c.n_layers):
            self.add_module(f"block{i}", TransformerBlock(
                c.d_model, c.n_heads, c.ffn_mult, c.dropout, gen))
        self.LayerNorm_0 = LayerNorm(c.d_model)
        self.out = Dense(c.d_model, c.vocab_sz, gen)
        self.eval()
        if device is not None:
            self.to(device)

    def forward(self, x, lengths=None, generator=None):
        """x: [N, T, F...] -> log-probs [N, T, V]; `lengths` [N] masks
        the attention to each row's valid frames."""
        c = self.cfg
        x = x.reshape(x.shape[0], x.shape[1], -1).float()
        if self.in_proj is not None:
            x = self.in_proj(x)
        t = x.shape[1]
        x = x + torch.from_numpy(_positions(t, c.d_model)).to(x.device)[None]
        mask = None
        if lengths is not None:
            valid = torch.arange(t, device=x.device)[None, :] < lengths.to(x.device)[:, None]
            mask = valid[:, None, None, :] & valid[:, None, :, None]
        if self.training and c.dropout > 0.0 and generator is None:
            raise ValueError("CTCModel in training needs a torch.Generator")
        for i in range(c.n_layers):
            x = getattr(self, f"block{i}")(x, mask, generator)
        return torch.log_softmax(self.out(self.LayerNorm_0(x)), dim=-1)


def ctc_loss(log_probs, labels, frame_lengths, label_lengths, blank: int = 0):
    """Per-sequence CTC loss [N], optax.ctc_loss's forward recursion (the
    log-probs are renormalised first, as it does), then nan_to_num with
    +inf as 0, as the JAX package applies it. labels [N, U] are padded
    past label_lengths; frames past frame_lengths are skipped."""
    logp = torch.log_softmax(log_probs.float(), dim=-1)
    n, t, _ = logp.shape
    u = labels.shape[1]
    dev = logp.device
    labels = labels.long().to(dev)
    frame_pad = (torch.arange(t, device=dev)[None, :]
                 >= frame_lengths.to(dev)[:, None]).float()           # [N, T]
    labellens = label_lengths.to(dev).long()
    repeat = torch.zeros((n, u), device=dev)
    if u > 1:
        repeat[:, :-1] = (labels[:, :-1] == labels[:, 1:]).float()
    phi_t = logp[:, :, blank]                                          # [N, T]
    emit_t = torch.gather(logp, 2, labels[:, None, :].expand(n, t, u))  # [N, T, U]
    phi = torch.full((n, u + 1), LOG_EPSILON, device=dev)
    phi = torch.cat([torch.zeros((n, 1), device=dev), phi[:, 1:]], 1)
    emit = torch.full((n, u), LOG_EPSILON, device=dev)

    def add_phi(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)], 1)

    for i in range(t):
        prev_phi_orig = phi
        prev_phi = add_phi(phi, emit + LOG_EPSILON * repeat)
        lp_emit, lp_phi = emit_t[:, i], phi_t[:, i:i + 1]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit, emit + lp_emit)
        next_phi = add_phi(prev_phi + lp_phi,
                           emit + lp_phi + LOG_EPSILON * (1.0 - repeat))
        pad = frame_pad[:, i:i + 1]
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = add_phi(phi, emit)
    loss = -torch.gather(last, 1, labellens[:, None])[:, 0]
    return torch.nan_to_num(loss, posinf=0.0)


@torch.no_grad()
def ctc_decode_greedy(log_probs, lengths, blank: int = 0, max_tokens: int = 256):
    """argmax -> collapse repeats -> drop blanks, within each row's
    length. Returns (tokens [N, max_tokens] int32, zero past each
    count, counts [N] int32): the first max_tokens emissions."""
    n, t, _ = log_probs.shape
    dev = log_probs.device
    pred = torch.argmax(log_probs, dim=-1)
    valid = torch.arange(t, device=dev)[None, :] < lengths.to(dev)[:, None]
    prev = torch.cat([torch.full((n, 1), -1, device=dev, dtype=pred.dtype),
                      pred[:, :-1]], 1)
    emit = (pred != blank) & (pred != prev) & valid
    pos = torch.cumsum(emit.long(), 1) - 1
    keep = emit & (pos < max_tokens)
    buf = torch.zeros((n, max_tokens), dtype=torch.int32, device=dev)
    rows = torch.arange(n, device=dev)[:, None].expand(n, t)
    buf[rows[keep], pos[keep]] = pred[keep].int()
    return buf, torch.clamp(emit.sum(1), max=max_tokens).int()
