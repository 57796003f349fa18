"""Batched greedy transducer decoding, with LM shallow fusion (the JAX
package's models/decode.py).

N streams decode in lockstep: a loop over encoder frames, and inside it
at most `max_iters` joint/predictor rounds with a per-stream active
mask. Streams that emit blank stop for the frame; the predictor and the
token buffer change only for streams that emitted.

LM fusion follows the reference's LMFuser: both distributions are
standardized (mean 0, population standard deviation 1), blank is pinned
to MIN_VAL, fused = alpha * lm + theta * joint, and the fused argmax
replaces the joint's, only where the joint's argmax was not blank and
the stream's LM has seen a token (`lm_primed`). The LM steps on every
row each round and its state moves only where a stream emitted. Beam
search fuses differently (models/beam.py).

Early exit: the JAX while_loop stops a frame's rounds once no stream is
active. Here that test is a host sync per round (`active.any()`). The
offline decode takes it, because most frames of real speech are blank
for every stream: one joint round then replaces `max_iters` rounds of
joint and predictor work. `decode_frame(early_exit=False)` runs all
`max_iters` rounds masked instead, which gives the same tokens, lengths
and state with no host sync: the streaming step, captured as one CUDA
graph, takes that form.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable

import torch

MIN_VAL = -10.0  # the blank's value in the fused distributions


def _standardize(x, eps: float = 1e-6):
    # population standard deviation (correction 0), as jnp.std
    mu = x.mean(dim=-1, keepdim=True)
    sd = x.std(dim=-1, keepdim=True, correction=0)
    return (x - mu) / (sd + eps)


def _pin_blank(x, blank: int):
    x = x.clone()
    x[..., blank] = MIN_VAL
    return x


@dataclass(frozen=True)
class DecoderFns:
    """Model endpoints bound to parameters."""

    predict_step: Callable  # (y [N,1], state) -> (h [N,1,H], state)
    joint_step: Callable    # (h_pred [N,H], h_enc [N,H]) -> logits [N,V]
    lm_step: Callable | None = None  # (y [N,1], state) -> (logp [N,1,V], state)
    lm_init_state: Callable | None = None  # (n) -> state


@dataclass(frozen=True)
class DecodeState:
    pred_state: Any           # predictor carry: per layer, a tuple of [N,H]
    h_pred: torch.Tensor      # [N, H] current predictor output
    last_token: torch.Tensor  # [N] int64
    y_buf: torch.Tensor       # [N, max_tokens] int64
    y_len: torch.Tensor       # [N] int64
    lm_state: Any             # LM carry per layer, () without an LM
    lm_logits: torch.Tensor   # [N, V] standardized LM log-probs, blank pinned
    lm_primed: torch.Tensor   # [N] bool: the LM has seen a token
    sum_iters: torch.Tensor   # [N] rounds run while active
    ones: torch.Tensor        # [N] frames that took exactly one round


def init_decode_state(fns: DecoderFns, n: int, *, vocab_sz: int = 0,
                      bos: int = 2, max_tokens: int = 256,
                      device=None) -> DecodeState:
    """BOS-prime the predictor; the LM starts from zeros, unprimed (it
    is not stepped on BOS). With an LM, `vocab_sz` sizes lm_logits."""
    bos_tok = torch.full((n, 1), bos, dtype=torch.long, device=device)
    h, pred_state = fns.predict_step(bos_tok, None)
    lm_state = ()
    if fns.lm_step is not None:
        if vocab_sz < 1:
            raise ValueError("LM fusion needs the vocabulary size")
        lm_state = fns.lm_init_state(n)
    zeros = torch.zeros(n, dtype=torch.long, device=device)
    return DecodeState(
        pred_state=pred_state,
        h_pred=h[:, 0, :],
        last_token=torch.full((n,), bos, dtype=torch.long, device=device),
        y_buf=torch.zeros((n, max_tokens), dtype=torch.long, device=device),
        y_len=zeros,
        lm_state=lm_state,
        lm_logits=torch.zeros((n, vocab_sz), device=device),
        lm_primed=torch.zeros(n, dtype=torch.bool, device=device),
        sum_iters=zeros,
        ones=zeros,
    )


def _masked_update(mask, new, old):
    """Per-stream select over nested tuples of [N, ...] tensors."""
    if isinstance(new, (tuple, list)):
        return tuple(_masked_update(mask, a, b) for a, b in zip(new, old))
    m = mask.reshape((-1,) + (1,) * (new.dim() - 1))
    return torch.where(m, new, old)


def decode_frame(fns: DecoderFns, st: DecodeState, h_enc, frame_valid, *,
                 blank: int = 0, max_iters: int = 3,
                 fusion_alpha: float = 0.1, fusion_theta: float = 1.0,
                 early_exit: bool = True) -> DecodeState:
    """Decode one encoder frame h_enc [N, H] for all streams. With
    `early_exit`, the rounds stop once no stream is active (a host sync
    a round); without it all `max_iters` rounds run, inactive streams
    masked."""
    start_iters = st.sum_iters
    active = frame_valid
    max_tokens = st.y_buf.shape[1]
    use_lm = fns.lm_step is not None
    for _ in range(max_iters):
        if early_exit and not bool(active.any()):
            break
        logits = fns.joint_step(st.h_pred, h_enc)
        logp = torch.log_softmax(logits, dim=-1)
        pred = torch.argmax(logp, dim=-1)
        emit = active & (pred != blank)
        if use_lm:
            # fuse only streams that would emit and whose LM has context
            fused = (fusion_alpha * st.lm_logits
                     + fusion_theta * _pin_blank(_standardize(logp), blank))
            pred = torch.where(emit & st.lm_primed,
                               torch.argmax(fused, dim=-1), pred)
            emit = active & (pred != blank)
        store = emit & (st.y_len < max_tokens)
        slot = st.y_len.clamp(max=max_tokens - 1)[:, None]
        cur = st.y_buf.gather(1, slot)[:, 0]
        y_buf = st.y_buf.scatter(1, slot, torch.where(store, pred, cur)[:, None])
        tok = torch.where(emit, pred, st.last_token)
        h_new, ps_new = fns.predict_step(tok[:, None], st.pred_state)
        lm_state, lm_logits, lm_primed = st.lm_state, st.lm_logits, st.lm_primed
        if use_lm:
            lm_logp, lm_new = fns.lm_step(tok[:, None], st.lm_state)
            lm_std = _pin_blank(_standardize(lm_logp[:, -1, :]), blank)
            lm_logits = torch.where(emit[:, None], lm_std, st.lm_logits)
            lm_state = _masked_update(emit, lm_new, st.lm_state)
            lm_primed = st.lm_primed | emit
        st = replace(
            st,
            pred_state=_masked_update(emit, ps_new, st.pred_state),
            h_pred=torch.where(emit[:, None], h_new[:, 0, :], st.h_pred),
            last_token=tok,
            y_buf=y_buf,
            y_len=st.y_len + store.long(),
            lm_state=lm_state,
            lm_logits=lm_logits,
            lm_primed=lm_primed,
            sum_iters=st.sum_iters + active.long(),
        )
        active = emit
    return replace(st, ones=st.ones + (st.sum_iters - start_iters == 1).long())


def greedy_decode(fns: DecoderFns, enc_out, enc_lengths, *, vocab_sz: int = 0,
                  blank: int = 0, bos: int = 2, max_iters: int = 3,
                  max_tokens: int = 256, fusion_alpha: float = 0.1,
                  state: DecodeState | None = None):
    """enc_out: [N, T, H]; enc_lengths: [N]. Returns (tokens [N,
    max_tokens], lengths [N], metrics, state). `vocab_sz` is needed
    with an LM (fns.lm_step)."""
    n, t, _ = enc_out.shape
    if state is None:
        state = init_decode_state(fns, n, vocab_sz=vocab_sz, bos=bos,
                                  max_tokens=max_tokens, device=enc_out.device)
    for ti in range(t):
        state = decode_frame(fns, state, enc_out[:, ti], ti < enc_lengths,
                             blank=blank, max_iters=max_iters,
                             fusion_alpha=fusion_alpha)
    s = state.sum_iters.float()
    metrics = {"alignment_score": (s - state.ones) / (s + 1e-4)}
    return state.y_buf, state.y_len, metrics, state
