"""Batched greedy transducer decoding (the JAX package's
models/decode.py without LM fusion).

N streams decode in lockstep: a loop over encoder frames, and inside it
at most `max_iters` joint/predictor rounds with a per-stream active
mask. Streams that emit blank stop for the frame; the predictor and the
token buffer change only for streams that emitted.

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


@dataclass(frozen=True)
class DecoderFns:
    """Model endpoints bound to parameters."""

    predict_step: Callable  # (y [N,1], state) -> (h [N,1,H], state)
    joint_step: Callable    # (h_pred [N,H], h_enc [N,H]) -> logits [N,V]


@dataclass(frozen=True)
class DecodeState:
    pred_state: Any           # predictor carry: per layer, a tuple of [N,H]
    h_pred: torch.Tensor      # [N, H] current predictor output
    last_token: torch.Tensor  # [N] int64
    y_buf: torch.Tensor       # [N, max_tokens] int64
    y_len: torch.Tensor       # [N] int64
    sum_iters: torch.Tensor   # [N] rounds run while active
    ones: torch.Tensor        # [N] frames that took exactly one round


def init_decode_state(fns: DecoderFns, n: int, *, bos: int = 2,
                      max_tokens: int = 256, device=None) -> DecodeState:
    """BOS-prime the predictor."""
    bos_tok = torch.full((n, 1), bos, dtype=torch.long, device=device)
    h, pred_state = fns.predict_step(bos_tok, None)
    zeros = torch.zeros(n, dtype=torch.long, device=device)
    return DecodeState(
        pred_state=pred_state,
        h_pred=h[:, 0, :],
        last_token=torch.full((n,), bos, dtype=torch.long, device=device),
        y_buf=torch.zeros((n, max_tokens), dtype=torch.long, device=device),
        y_len=zeros,
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
                 early_exit: bool = True) -> DecodeState:
    """Decode one encoder frame h_enc [N, H] for all streams. With
    `early_exit`, the rounds stop once no stream is active (a host sync
    a round); without it all `max_iters` rounds run, inactive streams
    masked."""
    start_iters = st.sum_iters
    active = frame_valid
    max_tokens = st.y_buf.shape[1]
    for _ in range(max_iters):
        if early_exit and not bool(active.any()):
            break
        logits = fns.joint_step(st.h_pred, h_enc)
        pred = torch.argmax(torch.log_softmax(logits, dim=-1), dim=-1)
        emit = active & (pred != blank)
        store = emit & (st.y_len < max_tokens)
        slot = st.y_len.clamp(max=max_tokens - 1)[:, None]
        cur = st.y_buf.gather(1, slot)[:, 0]
        y_buf = st.y_buf.scatter(1, slot, torch.where(store, pred, cur)[:, None])
        tok = torch.where(emit, pred, st.last_token)
        h_new, ps_new = fns.predict_step(tok[:, None], st.pred_state)
        st = replace(
            st,
            pred_state=_masked_update(emit, ps_new, st.pred_state),
            h_pred=torch.where(emit[:, None], h_new[:, 0, :], st.h_pred),
            last_token=tok,
            y_buf=y_buf,
            y_len=st.y_len + store.long(),
            sum_iters=st.sum_iters + active.long(),
        )
        active = emit
    return replace(st, ones=st.ones + (st.sum_iters - start_iters == 1).long())


def greedy_decode(fns: DecoderFns, enc_out, enc_lengths, *, blank: int = 0,
                  bos: int = 2, max_iters: int = 3, max_tokens: int = 256,
                  state: DecodeState | None = None):
    """enc_out: [N, T, H]; enc_lengths: [N].
    Returns (tokens [N, max_tokens], lengths [N], metrics, state)."""
    n, t, _ = enc_out.shape
    if state is None:
        state = init_decode_state(fns, n, bos=bos, max_tokens=max_tokens,
                                  device=enc_out.device)
    for ti in range(t):
        state = decode_frame(fns, state, enc_out[:, ti], ti < enc_lengths,
                             blank=blank, max_iters=max_iters)
    s = state.sum_iters.float()
    metrics = {"alignment_score": (s - state.ones) / (s + 1e-4)}
    return state.y_buf, state.y_len, metrics, state
