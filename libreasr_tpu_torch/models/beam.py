"""Batched frame-synchronous beam search for RNN-T, with LM shallow
fusion (the JAX package's models/beam.py).

- N streams x K beams advance in lockstep; the predictor and LM steps
  run as one [N*K] batched call per expansion round;
- per frame, up to `max_expand` expansion rounds: every active beam
  either takes blank (it enters the `finished` pool for this frame) or
  extends with one token; candidates are ranked over the flattened
  (beam, token) space;
- log-linear LM fusion: a non-blank extension scores
  `logp + lm_alpha * lm_logp[token] + lm_beta` (beta, the insertion
  bonus, offsets the per-token LM cost), the LM state carried per beam;
- fixed shapes: hypothesis buffers are [N, K, max_tokens].

Early exit, as in models/decode.py: offline (`early_exit=True`) the
rounds stop once no beam of any stream is active, a host sync a round,
where the JAX while_loop stops. The streaming step runs all
`max_expand` rounds masked. Both give the same merged pool: after the
last active round the blank pool is all NEG, and the merge keeps the
`finished` pool on those ties (lower index first).

Leaves are told apart by field, not by shape: `pred_state` and
`lm_state` hold [N*K, ...] tensors, every other field [N, K, ...].
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Any

import torch

from .decode import DecoderFns

NEG = -1e30
_FLAT_FIELDS = ("pred_state", "lm_state")  # [N*K, ...] leaves


@dataclass(frozen=True)
class BeamState:
    pred_state: Any           # per layer, a tuple of [N*K, H]
    h_pred: torch.Tensor      # [N, K, H]
    last_token: torch.Tensor  # [N, K] int64
    scores: torch.Tensor      # [N, K] float32
    y_buf: torch.Tensor       # [N, K, max_tokens] int64
    y_len: torch.Tensor       # [N, K] int64
    lm_state: Any             # LM carry per layer, [N*K, H] each; () without
    lm_logp: torch.Tensor     # [N, K, V] next-token LM log-probs


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tuple(_map(fn, t) for t in tree)


def _map2(fn, a, b):
    if isinstance(a, torch.Tensor):
        return fn(a, b)
    return tuple(_map2(fn, x, y) for x, y in zip(a, b))


def _by_field(st: BeamState, flat, nk, other=None) -> BeamState:
    """Apply `flat` to the [N*K, ...] leaves and `nk` to the [N, K, ...]
    leaves of one state (other None) or of two (a, b)."""
    out = {}
    for f in dataclasses.fields(st):
        fn = flat if f.name in _FLAT_FIELDS else nk
        a = getattr(st, f.name)
        out[f.name] = (_map(fn, a) if other is None
                       else _map2(fn, a, getattr(other, f.name)))
    return BeamState(**out)


def repeat_rows(x, k: int):
    """[N, ...] -> [N*K, ...], each row repeated K times in place:
    jnp.repeat(x, k, axis=0), i.e. repeat_interleave (not Tensor.repeat,
    which tiles). Written as expand + reshape, which never syncs with
    the host, so that it can be captured in a CUDA graph."""
    return x.unsqueeze(1).expand(x.shape[0], k, *x.shape[1:]).reshape(
        x.shape[0] * k, *x.shape[1:])


def _take(x, idx):
    """x [N, K, ...] gathered along K by idx [N, M] -> [N, M, ...]."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.take_along_dim(x, idx, dim=1)


def _gather_beams(tree, idx, n: int, k: int):
    """Reorder [N*K, ...] leaves by a per-stream beam index [N, K]."""
    def g(x):
        return _take(x.reshape(n, k, *x.shape[1:]), idx).reshape(x.shape)
    return _map(g, tree)


def _top_k(x, k: int):
    """The k largest along the last axis, in descending order, the lower
    index first among equal values, as jax.lax.top_k orders them.
    torch.topk promises no order among ties, and ties are routine here:
    dead beams all score exactly NEG. A stable descending sort keeps the
    lower index first."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def init_beam_state(fns: DecoderFns, n: int, k: int, vocab_sz: int, *,
                    bos: int, max_tokens: int, device=None) -> BeamState:
    """Every beam BOS-primed, only beam 0 live. Unlike greedy fusion, the
    LM is stepped on BOS here, so lm_logp holds its next-token
    log-probs from the start."""
    bos_tok = torch.full((n * k, 1), bos, dtype=torch.long, device=device)
    h, pred_state = fns.predict_step(bos_tok, None)
    scores = torch.full((n, k), NEG, device=device)
    scores[:, 0] = 0.0
    if fns.lm_step is not None:
        lm_logp, lm_state = fns.lm_step(bos_tok, fns.lm_init_state(n * k))
        lm_logp = lm_logp[:, -1, :].reshape(n, k, vocab_sz)
    else:
        lm_state = ()
        lm_logp = torch.zeros((n, k, vocab_sz), device=device)
    return BeamState(
        pred_state=pred_state,
        h_pred=h[:, 0, :].reshape(n, k, -1),
        last_token=torch.full((n, k), bos, dtype=torch.long, device=device),
        scores=scores,
        y_buf=torch.zeros((n, k, max_tokens), dtype=torch.long, device=device),
        y_len=torch.zeros((n, k), dtype=torch.long, device=device),
        lm_state=lm_state,
        lm_logp=lm_logp,
    )


def collapse_to_best(beam: BeamState) -> BeamState:
    """Collapse every stream's pool to its best beam: all K slots take the
    best beam's predictor/LM state and context, the hypothesis buffers
    empty, only slot 0 live (the init_beam_state pattern). Used by the
    streaming engine's forced commit when the uncommitted-token buffer
    saturates; diversity rebuilds from the next frame's top-k."""
    n, k, _ = beam.y_buf.shape
    best = torch.argmax(beam.scores, dim=1)  # the first maximum, as JAX
    idx = best[:, None].expand(n, k)
    out = _by_field(beam, lambda x: _gather_beams(x, idx, n, k),
                    lambda x: _take(x, idx))
    best_score = beam.scores.gather(1, best[:, None])[:, 0]
    scores = torch.full_like(beam.scores, NEG)
    scores[:, 0] = best_score
    return replace(out, scores=scores, y_buf=torch.zeros_like(beam.y_buf),
                   y_len=torch.zeros_like(beam.y_len))


def _merge_pools(a: BeamState, b: BeamState, n: int, k: int) -> BeamState:
    """Top-K merge of two K-slot pools (full state snapshots): the 2K
    candidates ranked by score, pool a first among ties (top-k ties,
    see _top_k)."""
    top_scores, idx = _top_k(torch.cat([a.scores, b.scores], dim=1), k)

    def nk(x, y):
        return _take(torch.cat([x, y], dim=1), idx)

    def flat(x, y):
        both = torch.cat([x.reshape(n, k, *x.shape[1:]),
                          y.reshape(n, k, *y.shape[1:])], dim=1)
        return _take(both, idx).reshape(x.shape)

    return replace(_by_field(a, flat, nk, other=b), scores=top_scores)


def beam_frame(fns: DecoderFns, st: BeamState, h_enc, frame_valid, *,
               blank: int = 0, max_expand: int = 3, lm_alpha: float = 0.1,
               lm_beta: float = 0.0, early_exit: bool = True) -> BeamState:
    """One encoder frame h_enc [N, H] for every stream; frame_valid [N]
    bool. Invalid frames keep the previous state wholesale."""
    n, k = st.scores.shape
    vocab = st.lm_logp.shape[-1]
    cap = st.y_buf.shape[-1]
    use_lm = fns.lm_step is not None
    h_enc_k = repeat_rows(h_enc, k)
    active = frame_valid[:, None] & (st.scores > NEG / 2)
    # dead or invalid slots enter the finished pool with their score
    finished = replace(st, scores=torch.where(active, NEG, st.scores))
    cur = st
    for _ in range(max_expand):
        if early_exit and not bool(active.any()):
            break
        logp = torch.log_softmax(
            fns.joint_step(cur.h_pred.reshape(n * k, -1), h_enc_k), dim=-1
        ).reshape(n, k, vocab)

        # blank candidates: the full state, score + logp[blank]
        blank_scores = torch.where(active, cur.scores + logp[:, :, blank], NEG)
        finished = _merge_pools(finished, replace(cur, scores=blank_scores),
                                n, k)

        # non-blank extensions; the two fusions differ: beam adds
        # alpha * LM log-probs + beta to the raw joint log-probs, greedy
        # (models/decode.py) standardizes both and pins blank
        ext = cur.scores[:, :, None] + logp
        if use_lm:
            ext = ext + lm_alpha * cur.lm_logp + lm_beta
        ext[:, :, blank] = NEG
        ext = torch.where(active[:, :, None] & (cur.y_len < cap)[:, :, None],
                          ext, NEG)
        top_scores, flat_idx = _top_k(ext.reshape(n, k * vocab), k)
        src_beam = flat_idx // vocab
        token = flat_idx % vocab
        new_active = top_scores > NEG / 2

        # gather by source beam, append the token, step predictor and LM
        pred_state = _gather_beams(cur.pred_state, src_beam, n, k)
        y_buf = _take(cur.y_buf, src_beam)
        y_len = cur.y_len.gather(1, src_beam)
        at_end = torch.arange(cap, device=y_buf.device) == y_len[:, :, None]
        y_buf = torch.where(at_end & new_active[:, :, None], token[:, :, None],
                            y_buf)
        tok = token.reshape(n * k, 1)
        h_new, pred_state = fns.predict_step(tok, pred_state)
        lm_state, lm_logp = cur.lm_state, cur.lm_logp
        if use_lm:
            lm_out, lm_state = fns.lm_step(
                tok, _gather_beams(cur.lm_state, src_beam, n, k))
            lm_logp = lm_out[:, -1, :].reshape(n, k, vocab)
        cur = BeamState(
            pred_state=pred_state,
            h_pred=h_new[:, 0, :].reshape(n, k, -1),
            last_token=token,
            scores=top_scores,
            y_buf=y_buf,
            y_len=y_len + new_active.long(),
            lm_state=lm_state,
            lm_logp=lm_logp,
        )
        active = new_active

    # beams still active after max_expand rounds enter without a blank
    # transition (the forced-exit approximation)
    forced = replace(cur, scores=torch.where(active, cur.scores, NEG))
    merged = _merge_pools(finished, forced, n, k)

    keep = ~frame_valid

    def sel(m):
        def f(new, old):
            return torch.where(m.reshape((-1,) + (1,) * (new.dim() - 1)),
                               old, new)
        return f

    return _by_field(merged, sel(repeat_rows(keep, k)), sel(keep), other=st)


def beam_decode(fns: DecoderFns, enc_out, enc_lengths, *, vocab_sz: int,
                beam_width: int = 4, blank: int = 0, bos: int = 2,
                max_expand: int = 3, max_tokens: int = 256,
                lm_alpha: float = 0.1, lm_beta: float = 0.0):
    """Batched beam search over enc_out [N, T, H], enc_lengths [N].
    Returns the best beam per stream: (tokens [N, max_tokens], lengths
    [N], scores [N])."""
    n, t, _ = enc_out.shape
    st = init_beam_state(fns, n, beam_width, vocab_sz, bos=bos,
                         max_tokens=max_tokens, device=enc_out.device)
    for ti in range(t):
        st = beam_frame(fns, st, enc_out[:, ti], ti < enc_lengths,
                        blank=blank, max_expand=max_expand, lm_alpha=lm_alpha,
                        lm_beta=lm_beta)
    best = torch.argmax(st.scores, dim=1)[:, None]
    toks = _take(st.y_buf, best)[:, 0]
    return toks, st.y_len.gather(1, best)[:, 0], st.scores.gather(1, best)[:, 0]
