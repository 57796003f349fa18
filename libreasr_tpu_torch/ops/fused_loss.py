"""Fused joint + RNN-T loss: the [N, T, U1, V] lattice is never built.

The JAX package's ops/fused_loss.py as a torch.autograd.Function over
(enc_out [N, T, H], pred_out [N, U1, H], the joint's parameters):

- forward: the two projections enc_out @ W_enc and pred_out @ W_pred + b
  (torch.matmul in the compute dtype, float32 accumulation), then the
  joint's log-probs of blank and of the next label, lp_blank [N, T, U1]
  and lp_emit [N, T, U], then the alphas. The V-free DP arrays are the
  residuals.
- backward: betas and occupancies give the cotangents g_lpb, g_lpe; they
  are pulled back through the joint to d_enc_proj, d_pred_proj, dW_out
  and db_out, and through the projections by autograd.

Two routes compute the joint's part. On CUDA tensors it always takes the
hand-written kernels F (forward), G and H (backward) of
ops/kernels/joint_lp.py. On CPU tensors it takes the chunked path of
the JAX package: t_chunk frames of logits at a time, recomputed in the
backward (the kernels' twin). The JAX package pads T to a multiple of
t_chunk first; padded frames never change the loss or its gradients, so
the port does not pad: the last chunk is shorter, and the kernels run
the T frames there are.

W_out's rounding type w(): the compute dtype where the model has one
(bf16 under base.yaml), else float32, on both routes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .kernels import joint_lp as kjoint
from .rnn import round_to
from .rnnt_loss import (
    backward_betas, forward_alphas, log_probs, occupancies, terminal_gather,
)


class JointParams(NamedTuple):
    w_pred: torch.Tensor  # [H, J]
    b_pred: torch.Tensor  # [J]
    w_enc: torch.Tensor   # [H, J]
    w_out: torch.Tensor   # [J, V]
    b_out: torch.Tensor   # [V]


def joint_params(joint) -> JointParams:
    """The parameters of the port's concat Joint module, as they are
    (gradients reach them through rnnt_loss_fused)."""
    return JointParams(joint.pred_proj.kernel, joint.pred_proj.bias,
                       joint.enc_proj.kernel, joint.out.kernel, joint.out.bias)


def _mmc(a, b, cdt):
    """a @ b with both inputs rounded to `cdt` and float32 accumulation."""
    return round_to(a.float(), cdt) @ round_to(b.float(), cdt)


def _pred_proj(pred_out, w_pred, b_pred, cdt):
    return _mmc(pred_out, w_pred, cdt) + b_pred.float()


def _chunk_lp(enc_c, pp, w_enc, w_out, b_out, labels, blank, cdt):
    """[N, Tc, H] x [N, U1, J] -> (lp_blank [N, Tc, U1], lp_emit [N, Tc, U])."""
    encp = _mmc(enc_c, w_enc, cdt)
    hidden = torch.tanh(encp[:, :, None, :] + pp[:, None, :, :])
    logits = _mmc(hidden, w_out, cdt) + b_out.float()
    return log_probs(logits, labels, blank)


class _FusedLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, enc_out, pred_out, w_pred, b_pred, w_enc, w_out, b_out,
                labels, fl, yl, blank, t_chunk, cdt, route):
        enc32, pred32 = enc_out.float(), pred_out.float()
        lab = labels.to(torch.int32).contiguous()
        if route == "kernels":
            encp = _mmc(enc32, w_enc, cdt).contiguous()
            pp = _pred_proj(pred32, w_pred, b_pred, cdt).contiguous()
            lpb, lpe = kjoint.joint_lp_fwd(
                encp, pp, w_out.to(cdt or torch.float32).contiguous(),
                b_out.float().contiguous(), lab, blank)
        else:
            pp = _pred_proj(pred32, w_pred, b_pred, cdt)
            parts = [_chunk_lp(enc32[:, s:s + t_chunk], pp, w_enc, w_out,
                               b_out, lab, blank, cdt)
                     for s in range(0, enc32.shape[1], t_chunk)]
            lpb = torch.cat([p[0] for p in parts], 1)
            lpe = torch.cat([p[1] for p in parts], 1)
        alpha, lpe_m = forward_alphas(lpb, lpe, yl)
        log_z = terminal_gather(alpha, lpb, fl, yl)
        ctx.save_for_backward(enc_out, pred_out, w_pred, b_pred, w_enc, w_out,
                              b_out, lab, fl, yl, lpb, lpe_m, alpha, log_z)
        ctx.cfg = (blank, t_chunk, cdt, route)
        return -log_z

    @staticmethod
    def backward(ctx, g):
        (enc_out, pred_out, w_pred, b_pred, w_enc, w_out, b_out, lab, fl, yl,
         lpb, lpe_m, alpha, log_z) = ctx.saved_tensors
        blank, t_chunk, cdt, route = ctx.cfg
        beta = backward_betas(lpb, lpe_m, fl, yl)
        occ_b, occ_e = occupancies(lpb, lpe_m, alpha, beta, fl, yl, log_z)
        g = g.float()
        g_lpb = (-occ_b * g[:, None, None]).contiguous()
        g_lpe = (-occ_e * g[:, None, None]).contiguous()
        leaves = [x.detach().float().requires_grad_()
                  for x in (enc_out, pred_out, w_pred, b_pred, w_enc)]
        e, po, wp, bp, we = leaves
        with torch.enable_grad():
            pp = _pred_proj(po, wp, bp, cdt)
            if route == "kernels":
                encp = _mmc(e, we, cdt)
                wq = w_out.detach().to(cdt or torch.float32).contiguous()
                bq = b_out.detach().float().contiguous()
                d_encp, d_pp, lse = kjoint.joint_lp_dx(
                    encp.detach().contiguous(), pp.detach().contiguous(), wq,
                    bq, lab, g_lpb, g_lpe, blank)
                d_wout, d_bout = kjoint.joint_lp_dw(
                    encp.detach().contiguous(), pp.detach().contiguous(), wq,
                    bq, lab, g_lpb, g_lpe, lse, blank)
                d_e, d_we, d_po, d_wp, d_bp = torch.autograd.grad(
                    [encp, pp], [e, we, po, wp, bp], [d_encp, d_pp])
            else:
                d_e, d_we, d_pp, d_wout, d_bout = _chunked_bwd(
                    e, pp.detach(), we, w_out, b_out, lab, g_lpb, g_lpe,
                    blank, t_chunk, cdt)
                d_po, d_wp, d_bp = torch.autograd.grad(pp, [po, wp, bp], d_pp)
        return (d_e.to(enc_out.dtype), d_po.to(pred_out.dtype),
                d_wp.to(w_pred.dtype), d_bp.to(b_pred.dtype),
                d_we.to(w_enc.dtype), d_wout.to(w_out.dtype),
                d_bout.to(b_out.dtype), None, None, None, None, None, None, None)


def _chunked_bwd(enc32, pp, w_enc, w_out, b_out, lab, g_lpb, g_lpe, blank,
                 t_chunk, cdt):
    """Pull (g_lpb, g_lpe) back through the joint t_chunk frames at a
    time, recomputing each chunk's logits. Returns the cotangents of
    (enc_out, W_enc, pred_proj, W_out, b_out)."""
    pp = pp.requires_grad_()
    we = w_enc.detach().float().requires_grad_()
    wo = w_out.detach().float().requires_grad_()
    bo = b_out.detach().float().requires_grad_()
    d_e, sums = [], None
    for s in range(0, enc32.shape[1], t_chunk):
        ec = enc32[:, s:s + t_chunk].detach().requires_grad_()
        with torch.enable_grad():
            lpb, lpe = _chunk_lp(ec, pp, we, wo, bo, lab, blank, cdt)
            grads = torch.autograd.grad(
                [lpb, lpe], [ec, we, pp, wo, bo],
                [g_lpb[:, s:s + t_chunk], g_lpe[:, s:s + t_chunk]])
        d_e.append(grads[0])
        sums = list(grads[1:]) if sums is None else [
            a + b for a, b in zip(sums, grads[1:])]
    return (torch.cat(d_e, 1), *sums)


def _fused(enc_out, pred_out, jp: JointParams, labels, frame_lengths,
           label_lengths, blank, t_chunk, compute_dtype, route):
    return _FusedLoss.apply(enc_out, pred_out, *jp, labels,
                            frame_lengths.long(), label_lengths.long(), blank,
                            t_chunk, compute_dtype, route)


def rnnt_loss_fused(enc_out, pred_out, jp: JointParams, labels, frame_lengths,
                    label_lengths, blank: int = 0, t_chunk: int = 16,
                    compute_dtype=None):
    """Per-sequence RNN-T loss [N] from the raw encoder and predictor
    outputs (enc_out [N, T, H], pred_out [N, U+1, H], labels [N, U]),
    differentiable in enc_out, pred_out and the joint's parameters.
    CUDA tensors run kernels F, G, H; CPU tensors the chunked path."""
    dev = enc_out.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"rnnt_loss_fused: unsupported device {enc_out.device}")
    return _fused(enc_out, pred_out, jp, labels, frame_lengths, label_lengths,
                  blank, t_chunk, compute_dtype,
                  "kernels" if dev == "cuda" else "chunked")
