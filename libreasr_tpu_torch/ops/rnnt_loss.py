"""RNN-Transducer loss as a log-space dynamic program in plain PyTorch.

The JAX package's ops/rnnt_loss.py, with its grid convention: logits
[N, T, U+1, V], labels [N, U], blank advances t, emitting label u
advances u, the final blank at (fl-1, yl) leaves the lattice.

alpha[t, u] depends on alpha[t-1, u] and alpha[t, u-1] only, so every
cell of one anti-diagonal t + u = d depends on diagonal d - 1 alone:
the DP runs as T + U1 - 1 vector steps over the diagonals instead of
T * U1 cell steps (JAX runs a scan over T of associative scans over U;
the sums are the same, taken in another order). The gradient is
analytic, from the forward/backward occupancies, as JAX's custom_vjp.
"""

from __future__ import annotations

import torch

NEG = -1e30


def log_probs(logits, labels, blank: int):
    """-> (lp_blank [N, T, U1], lp_emit [N, T, U]), float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    lp_blank = logits[..., blank] - lse
    u = labels.shape[1]
    idx = labels.long()[:, None, :, None].expand(-1, logits.shape[1], -1, 1)
    emit = torch.gather(logits[:, :, :u, :], -1, idx)[..., 0]
    return lp_blank, emit - lse[:, :, :u]


def _diagonal(d: int, t: int, u1: int, device):
    lo, hi = max(0, d - u1 + 1), min(d, t - 1)
    ti = torch.arange(lo, hi + 1, device=device)
    return ti, d - ti


def mask_emit(lp_emit, label_lengths):
    u = lp_emit.shape[2]
    keep = torch.arange(u, device=lp_emit.device)[None, :] < label_lengths[:, None]
    return torch.where(keep[:, None, :], lp_emit, torch.full_like(lp_emit, NEG))


@torch.no_grad()
def forward_alphas(lp_blank, lp_emit, label_lengths):
    """alpha [N, T, U1] and lp_emit masked to NEG at u >= label length."""
    n, t, u1 = lp_blank.shape
    dev = lp_blank.device
    lpe_m = mask_emit(lp_emit, label_lengths)
    # padded by one row and column of NEG in front: ap[:, t+1, u+1] = alpha[t, u];
    # the step terms shifted to the cell they enter: from_top[t, u] =
    # lp_blank[t-1, u], from_left[t, u] = lp_emit[t, u-1]
    ap = torch.full((n, t + 1, u1 + 1), NEG, device=dev)
    ap[:, 1, 1] = 0.0
    from_top = torch.cat([torch.zeros_like(lp_blank[:, :1]), lp_blank[:, :-1]], 1)
    from_left = torch.cat([torch.zeros_like(lp_blank[:, :, :1]), lpe_m], 2)
    for d in range(1, t + u1 - 1):
        ti, ui = _diagonal(d, t, u1, dev)
        ap[:, ti + 1, ui + 1] = torch.logaddexp(
            ap[:, ti, ui + 1] + from_top[:, ti, ui],
            ap[:, ti + 1, ui] + from_left[:, ti, ui])
    return ap[:, 1:, 1:].contiguous(), lpe_m


@torch.no_grad()
def backward_betas(lp_blank, lp_emit_m, frame_lengths, label_lengths):
    """beta [N, T, U1] with the lattice exit at (fl-1, yl):
    beta[t,u] = logaddexp(blank[t,u] + beta*[t+1,u], emit[t,u] + beta[t,u+1])
    where beta*[fl, u] is 0 at u == yl and NEG elsewhere."""
    n, t, u1 = lp_blank.shape
    dev = lp_blank.device
    u_ids = torch.arange(u1, device=dev)
    exit_row = torch.where(u_ids[None, :] == label_lengths[:, None], 0.0, NEG)
    # one row and one column of NEG behind: bp[:, t, u] = beta[t, u]
    bp = torch.full((n, t + 1, u1 + 1), NEG, device=dev)
    e_full = torch.cat([lp_emit_m, torch.full((n, t, 1), NEG, device=dev)], 2)
    fl = frame_lengths[:, None]
    for d in range(t + u1 - 2, -1, -1):
        ti, ui = _diagonal(d, t, u1, dev)
        b_next = torch.where(ti[None, :] + 1 == fl, exit_row[:, ui],
                             bp[:, ti + 1, ui])
        bp[:, ti, ui] = torch.logaddexp(lp_blank[:, ti, ui] + b_next,
                                        e_full[:, ti, ui] + bp[:, ti, ui + 1])
    return bp[:, :t, :u1].contiguous()


def terminal_gather(alpha, lp_blank, frame_lengths, label_lengths):
    """logZ[n] = alpha[n, fl-1, yl] + lp_blank[n, fl-1, yl]."""
    rows = torch.arange(alpha.shape[0], device=alpha.device)
    tl = frame_lengths.long() - 1
    yl = label_lengths.long()
    return alpha[rows, tl, yl] + lp_blank[rows, tl, yl]


@torch.no_grad()
def occupancies(lp_blank, lp_emit_m, alpha, beta, frame_lengths,
                label_lengths, log_z):
    """Posterior transition occupancies (occ_blank [N, T, U1], occ_emit
    [N, T, U]), zero outside the valid (t, u) region; d(-logZ)/d lp =
    -occ. Shared by rnnt_loss's backward and the fused loss's."""
    n, t, u1 = lp_blank.shape
    dev = lp_blank.device
    t_ids = torch.arange(t, device=dev)
    u_ids = torch.arange(u1, device=dev)
    fl, yl = frame_lengths[:, None], label_lengths[:, None]
    valid = (t_ids[None, :] < fl)[:, :, None] & (u_ids[None, :] <= yl)[:, None, :]
    exit_row = torch.where(u_ids[None, :] == yl, 0.0, NEG)
    beta_next_t = torch.cat([beta[:, 1:], torch.full((n, 1, u1), NEG, device=dev)], 1)
    beta_next_t = torch.where((t_ids[None, :] + 1 == fl)[:, :, None],
                              exit_row[:, None, :], beta_next_t)
    beta_next_u = torch.cat([beta[:, :, 1:], torch.full((n, t, 1), NEG, device=dev)], 2)
    lz = log_z[:, None, None]
    occ_blank = torch.exp(torch.clamp(alpha + lp_blank + beta_next_t - lz, NEG, 0.0))
    occ_emit = torch.exp(torch.clamp(
        alpha[:, :, :-1] + lp_emit_m + beta_next_u[:, :, :-1] - lz, NEG, 0.0))
    occ_blank = torch.where(valid, occ_blank, 0.0)
    occ_emit = torch.where(valid[:, :, :-1], occ_emit, 0.0)
    return occ_blank, occ_emit


class _RNNTLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, frame_lengths, label_lengths, blank):
        with torch.no_grad():
            lpb, lpe = log_probs(logits, labels, blank)
            alpha, _ = forward_alphas(lpb, lpe, label_lengths)
            log_z = terminal_gather(alpha, lpb, frame_lengths, label_lengths)
        ctx.save_for_backward(logits, labels, frame_lengths, label_lengths)
        ctx.blank = blank
        return -log_z

    @staticmethod
    def backward(ctx, g):
        logits, labels, fl, yl = ctx.saved_tensors
        blank = ctx.blank
        with torch.no_grad():
            x = logits.float()
            lpb, lpe = log_probs(x, labels, blank)
            alpha, lpe_m = forward_alphas(lpb, lpe, yl)
            beta = backward_betas(lpb, lpe_m, fl, yl)
            log_z = terminal_gather(alpha, lpb, fl, yl)
            occ_b, occ_e = occupancies(lpb, lpe_m, alpha, beta, fl, yl, log_z)
            total = occ_b.clone()
            total[:, :, :-1] += occ_e
            grad = torch.softmax(x, dim=-1) * total[..., None]
            grad[..., blank] -= occ_b
            v = x.shape[-1]
            hit = labels.long()[:, None, :, None] == torch.arange(v, device=x.device)
            grad[:, :, :-1] -= torch.where(hit, occ_e[..., None], 0.0)
            grad = grad * g[:, None, None, None]
        return grad.to(logits.dtype), None, None, None, None


def rnnt_loss(logits, labels, frame_lengths, label_lengths, blank: int = 0):
    """Per-sequence negative log-likelihood of the RNN-T lattice.
    logits [N, T, U+1, V] raw joint outputs; labels [N, U] integer;
    frame_lengths, label_lengths [N]. Returns loss [N] float32,
    differentiable in logits (analytic occupancy gradient)."""
    return _RNNTLoss.apply(logits, labels, frame_lengths.long(),
                           label_lengths.long(), blank)


def rnnt_loss_naive(logits, labels, frame_lengths, label_lengths,
                    blank: int = 0):
    """Cell-by-cell DP through autograd: the test oracle (O(T * U)
    sequential steps, small shapes only)."""
    lpb, lpe = log_probs(logits, labels, blank)
    n, t, u1 = lpb.shape
    lpe = mask_emit(lpe, label_lengths.long())
    rows = [torch.cat([torch.zeros((n, 1)), torch.cumsum(lpe[:, 0], 1)], 1)]
    for ti in range(1, t):
        a = rows[-1] + lpb[:, ti - 1]
        cells = [a[:, :1]]
        for ui in range(1, u1):
            cells.append(torch.logaddexp(a[:, ui:ui + 1],
                                         cells[-1] + lpe[:, ti, ui - 1:ui]))
        rows.append(torch.cat(cells, 1))
    alpha = torch.stack(rows, 1)
    return -terminal_gather(alpha, lpb, frame_lengths, label_lengths)
