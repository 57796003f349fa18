"""Train-step decomposition (the JAX package's
scripts/bench_step_parts.py): where the step's time goes.

bench_train_step measures the whole step against its speed of light.
This script times each stage on its own, with the same protocol (k
applications, then one wait for the card, against one; (T_k - T_1)/(k-1)
on the host clock, the median of `--reps`), so that the residue is
attributed by measurement instead of argument:

  frontend   device STFT->mel->SpecAug->stack (augment on)
  enc_fwd    encoder tower forward in training mode (kernel D)
  enc_bwd    encoder forward + grad wrt its parameters (D, E)
  pred_bwd   predictor forward + grad
  loss_bwd   fused joint+loss fwd+grad given fixed tower outputs (F, G, H)
  opt        ranger update + apply on fixed gradients

The parts need not sum to the full step (grads of a mean are not grads
of the loss; the step's launches interleave) — the point is each part's
distance from ITS roofline component.

Usage: python -m libreasr_tpu_torch.scripts.bench_step_parts [--bs 64] [--secs 6] [--k 8]

Runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def chained(fn, k):
    """A runner of k applications of fn(x) -> x, each fed the one before,
    closed by one wait for the card. Returns the last x."""

    def run(x):
        for _ in range(k):
            x = fn(x)
        torch.cuda.synchronize()
        return x

    return run


def timeit(label, fn1, fnk, x, k, reps):
    """Median over `reps` of (T_k - T_1)/(k - 1), host clock, in ms:
    the wait and what one application costs once cancel."""
    t0 = time.perf_counter()
    fn1(x)
    c1 = time.perf_counter() - t0
    fnk(x)
    deltas = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn1(x)
        t1 = time.perf_counter()
        fnk(x)
        t2 = time.perf_counter()
        deltas.append(((t2 - t1) - (t1 - t0)) / (k - 1))
    ms = float(np.median(deltas)) * 1e3
    print(f"  {label:10s} {ms:8.2f} ms/step   (first {c1:.1f} s)")
    return ms


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bs", type=int, default=64)
    ap.add_argument("--secs", type=float, default=6.0)
    ap.add_argument("--u", type=int, default=60)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--parts", default="",
                    help="comma list to restrict (frontend,enc_fwd,"
                         "enc_bwd,pred_bwd,loss_bwd,opt)")
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..config import DEFAULT_CONFIG, open_config
    from ..models.transducer import Transducer, TransducerConfig
    from ..ops.frontend import FrontendConfig, features_batch
    from ..ops.fused_loss import joint_params, rnnt_loss_fused
    from ..training.optimizers import apply_updates, build_optimizer

    dev = resolve_device(None)
    print(f"device: {torch.cuda.get_device_name(dev)}  "
          f"bs={args.bs} x {args.secs:.0f}s")

    conf = open_config(DEFAULT_CONFIG)
    conf["dtypes"]["compute"] = "bfloat16"
    cfg = TransducerConfig.from_config(conf)
    model = Transducer(cfg, seed=0, device=dev).train()
    frontend = FrontendConfig.from_config(conf)

    rng = np.random.default_rng(0)
    n_samp = int(args.secs * conf["sr"])
    pcm = (rng.standard_normal((args.bs, n_samp)) * 0.1).astype(np.float32)
    q = np.clip(np.round(pcm * 32768.0), -32768, 32767).astype(np.int16)
    audio = torch.from_numpy(q).to(dev)
    audio_len = torch.full((args.bs,), n_samp, dtype=torch.int32, device=dev)
    labels = torch.from_numpy(
        rng.integers(4, cfg.vocab_sz, (args.bs, args.u))).to(dev)
    yl = torch.full((args.bs,), args.u, dtype=torch.long, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    def enc_fwd(f):
        return model.encode(f, lengths=flens, generator=gen)[0]

    def pred_fwd(y):
        return model.predict(y, lengths=yl, generator=gen)[0]

    # the stages' inputs, made once on the card
    with torch.no_grad():
        feats, flens = features_batch(audio, audio_len, frontend,
                                      augment=True, generator=gen)
        flens_red = flens // max(cfg.reduction_factor, 1)
        enc_out = enc_fwd(feats)
        yconcat = torch.cat([torch.full((args.bs, 1), cfg.bos, dtype=labels.dtype,
                                        device=dev), labels], dim=1)
        pred_out = pred_fwd(yconcat)
    enc_params = list(model.encoder.parameters())
    pred_params = list(model.predictor.parameters())
    jp = joint_params(model.joint)

    tx = build_optimizer("ranger", 5e-4, weight_decay=0.01, grad_clip=10.0)
    params = [p.detach().clone() for p in model.parameters()]
    opt_state = tx.init(params)
    grads = [torch.full_like(p, 1e-4) for p in params]

    want = set(args.parts.split(",")) if args.parts else None
    k, reps = args.k, args.reps
    print(f"parts (chained k={k}, median of {reps}):")
    out = {}

    def maybe(name, step, x):
        if want and name not in want:
            return
        out[name] = timeit(name, chained(step, 1), chained(step, k), x, k, reps)

    @torch.no_grad()
    def fe_step(a):
        features_batch(a, audio_len, frontend, augment=True, generator=gen)
        return a

    maybe("frontend", fe_step, audio)

    @torch.no_grad()
    def ef_step(f):
        enc_fwd(f)
        return f

    maybe("enc_fwd", ef_step, feats)

    def eb_step(f):
        torch.autograd.grad(enc_fwd(f).float().mean(), enc_params,
                            allow_unused=True)
        return f

    maybe("enc_bwd", eb_step, feats)

    def pb_step(y):
        torch.autograd.grad(pred_fwd(y).float().mean(), pred_params,
                            allow_unused=True)
        return y

    maybe("pred_bwd", pb_step, yconcat)

    # fused loss fwd+bwd given fixed tower outputs: grads of the joint's
    # parameters
    def lb_step(e):
        per = rnnt_loss_fused(e, pred_out, jp, labels, flens_red, yl,
                              cfg.blank, 16, cfg.compute_dtype)
        torch.autograd.grad(per.mean(), list(jp))
        return e

    maybe("loss_bwd", lb_step, enc_out)

    @torch.no_grad()
    def opt_step(p):
        upd, _ = tx.update(grads, opt_state, p)
        apply_updates(p, upd)
        return p

    maybe("opt", opt_step, params)
    return out


if __name__ == "__main__":
    main()
