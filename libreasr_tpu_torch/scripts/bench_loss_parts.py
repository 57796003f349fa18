"""Fused-loss decomposition (the JAX package's
scripts/bench_loss_parts.py): the joint kernels against the DP.

Drills into bench_step_parts' loss_bwd with the same protocol (k
applications, one wait for the card, against one; (T_k - T_1)/(k-1) on
the host clock):

  lp_fwd     kernel F: (encp, pp) -> (lp_blank, lp_emit, lse)
  dp         alphas + betas + occupancies on fixed lp arrays (pure DP)
  lp_bwd     kernels G and H: occupancy grads -> d_encp, d_pp, dW, db
  loss_fwd   rnnt_loss_fused forward (F + alphas + gather)
  loss_bwd   its full backward via torch.autograd.grad (F, DP, G, H)

Usage: python -m libreasr_tpu_torch.scripts.bench_loss_parts [--bs 64] [--t 80] [--u 60]

Runs on the card and raises without one.
"""

from __future__ import annotations

import argparse

import torch

from .bench_step_parts import chained
from .bench_step_parts import timeit as _timeit


def timeit(label, fn, x, k, reps):
    """fn(kk): the runner of kk chained applications; as
    bench_step_parts.timeit, in ms."""
    return _timeit(label, fn(1), fn(k), x, k, reps)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bs", type=int, default=64)
    ap.add_argument("--t", type=int, default=80, help="padded enc frames")
    ap.add_argument("--u", type=int, default=60)
    ap.add_argument("--h", type=int, default=2048, help="tower out width")
    ap.add_argument("--j", type=int, default=1024)
    ap.add_argument("--v", type=int, default=2048)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..ops.fused_loss import JointParams, _mmc, _pred_proj, rnnt_loss_fused
    from ..ops.kernels.joint_lp import joint_lp_dw, joint_lp_dx, joint_lp_fwd
    from ..ops.rnnt_loss import (backward_betas, forward_alphas, occupancies,
                                 terminal_gather)

    dev = resolve_device(None)
    n, t, u, j, v = args.bs, args.t, args.u, args.j, args.v
    u1 = u + 1
    cdt = torch.bfloat16
    print(f"device: {torch.cuda.get_device_name(dev)}  N={n} T={t} U1={u1} "
          f"J={j} V={v}")

    g = torch.Generator(device=dev).manual_seed(0)

    def normal(*shape, scale):
        return torch.randn(shape, generator=g, device=dev) * scale

    enc_out = normal(n, t, args.h, scale=0.1)
    pred_out = normal(n, u1, args.h, scale=0.1)
    jp = JointParams(
        w_pred=normal(args.h, j, scale=0.02),
        b_pred=torch.zeros(j, device=dev),
        w_enc=normal(args.h, j, scale=0.02),
        w_out=normal(j, v, scale=0.02),
        b_out=torch.zeros(v, device=dev),
    )
    labels = torch.randint(4, v, (n, u), generator=g, device=dev)
    lab = labels.to(torch.int32).contiguous()
    fl = torch.full((n,), t, dtype=torch.long, device=dev)
    yl = torch.full((n,), u, dtype=torch.long, device=dev)

    # the kernels' inputs, as the fused loss makes them
    encp = _mmc(enc_out, jp.w_enc, cdt).contiguous()
    pp = _pred_proj(pred_out, jp.w_pred, jp.b_pred, cdt).contiguous()
    wq = jp.w_out.to(cdt).contiguous()
    bq = jp.b_out.float().contiguous()
    lpb0, lpe0, lse0 = joint_lp_fwd(encp, pp, wq, bq, lab, 0)
    g_lpb = -torch.ones_like(lpb0)
    g_lpe = -torch.ones_like(lpe0)
    torch.cuda.synchronize(dev)

    k, reps = args.k, args.reps
    print(f"parts (chained k={k}, median of {reps}):")
    out = {}

    @torch.no_grad()
    def fwd_step(e):
        joint_lp_fwd(e, pp, wq, bq, lab, 0)
        return e

    out["lp_fwd"] = timeit("lp_fwd", lambda kk: chained(fwd_step, kk), encp,
                           k, reps)

    # DP: alphas + terminal + betas + occupancies on fixed lp
    @torch.no_grad()
    def dp_step(lpb):
        alpha, lpe_m = forward_alphas(lpb, lpe0, yl)
        log_z = terminal_gather(alpha, lpb, fl, yl)
        beta = backward_betas(lpb, lpe_m, fl, yl)
        occupancies(lpb, lpe_m, alpha, beta, fl, yl, log_z)
        return lpb

    out["dp"] = timeit("dp", lambda kk: chained(dp_step, kk), lpb0, k, reps)

    @torch.no_grad()
    def bwd_step(e):
        joint_lp_dx(e, pp, wq, bq, lab, g_lpb, g_lpe, lse0, 0)
        joint_lp_dw(e, pp, wq, bq, lab, g_lpb, g_lpe, lse0, 0)
        return e

    out["lp_bwd"] = timeit("lp_bwd", lambda kk: chained(bwd_step, kk), encp,
                           k, reps)

    @torch.no_grad()
    def lf_step(e):
        rnnt_loss_fused(e, pred_out, jp, labels, fl, yl, 0, 16, cdt)
        return e

    out["loss_fwd"] = timeit("loss_fwd", lambda kk: chained(lf_step, kk),
                             enc_out, k, reps)

    def lb_step(e):
        e = e.detach().requires_grad_()
        loss = rnnt_loss_fused(e, pred_out, jp, labels, fl, yl, 0, 16, cdt)
        torch.autograd.grad(loss.mean(), e)
        return e.detach()

    out["loss_bwd"] = timeit("loss_bwd", lambda kk: chained(lb_step, kk),
                             enc_out, k, reps)
    return out


if __name__ == "__main__":
    main()
