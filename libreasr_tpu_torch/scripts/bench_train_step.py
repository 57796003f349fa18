"""Full flagship train-step benchmark (the JAX package's
scripts/bench_train_step.py).

Measures ms/step of the complete training step — device frontend
(SpecAugment) -> encoder (kernels D, E) -> fused joint + loss (kernels F,
G, H) -> gradients -> ranger update, one `Learner.step` — at the
flagship shape (6-2-1024, vocab 2048, the reference's english model,
docs/docs.md:129-137), on one batch: k steps, then one wait for the
card, timed on the host clock against a single step, reported as
(T_k - T_1)/(k-1), the median of `--reps` (bench_step_parts' protocol).
JAX's `--t-chunk` has no counterpart: the card's kernels F, G, H plan
their own time chunks.

Usage:
  python -m libreasr_tpu_torch.scripts.bench_train_step [--bs 16] [--secs 6] [--k 8]

Runs on the card and raises without one.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .bench_step_parts import chained, timeit


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bs", type=int, default=16)
    ap.add_argument("--secs", type=float, default=6.0)
    ap.add_argument("--u", type=int, default=60, help="label length")
    ap.add_argument("--k", type=int, default=8, help="chained steps")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-fused", action="store_true",
                    help="lattice loss instead of fused joint+loss")
    args = ap.parse_args(argv)

    from .. import flops as F
    from .. import resolve_device
    from ..config import DEFAULT_CONFIG, open_config
    from ..models.transducer import Transducer, TransducerConfig
    from ..ops.frontend import FrontendConfig
    from ..training.learner import Batch, Learner, LossConfig
    from ..training.optimizers import build_optimizer

    dev = resolve_device(None)
    print(f"device: {torch.cuda.get_device_name(dev)}")

    conf = open_config(DEFAULT_CONFIG)
    conf["dtypes"]["compute"] = "bfloat16"
    cfg = TransducerConfig.from_config(conf)
    model = Transducer(cfg, seed=0, device=dev)
    frontend = FrontendConfig.from_config(conf)
    loss_cfg = LossConfig(fused=not args.no_fused)
    tx = build_optimizer("ranger", 5e-4, weight_decay=0.01, grad_clip=10.0)
    learner = Learner(model, tx, frontend, loss_cfg, seed=0)

    rng = np.random.default_rng(0)
    n_samp = int(args.secs * conf["sr"])
    # int16 rows halve the upload; the frontend decodes them
    pcm = (rng.standard_normal((args.bs, n_samp)) * 0.1).astype(np.float32)
    q = np.clip(np.round(pcm * 32768.0), -32768, 32767).astype(np.int16)
    labels = rng.integers(4, cfg.vocab_sz, (args.bs, args.u)).astype(np.int32)
    batch = Batch(
        audio=torch.from_numpy(q).to(dev),
        audio_len=torch.full((args.bs,), n_samp, dtype=torch.int32, device=dev),
        labels=torch.from_numpy(labels).to(dev),
        label_len=torch.full((args.bs,), args.u, dtype=torch.int32, device=dev),
    )
    steps = 0

    def step(b):
        nonlocal steps
        learner.step(b)
        steps += 1
        return b

    ms = timeit("train_step", chained(step, 1), chained(step, args.k), batch,
                args.k, args.reps)
    audio_s = args.bs * args.secs
    # MFU: analytic matmul FLOPs (flops.py — encoder/predictor gates,
    # decomposed joint, loss DP, fwd + 2x bwd) over the card's bf16 peak
    t_frames = n_samp // (frontend.hop * frontend.downsample)
    fl = F.train_step_flops(cfg, args.bs, t_frames, args.u)
    m = F.mfu(fl, ms / 1e3)
    print(
        f"train step (bs={args.bs} x {args.secs:.0f}s, "
        f"fused={not args.no_fused}): {ms:.2f} ms/step "
        f"({audio_s / (ms / 1e3):.0f}x realtime, {m})"
    )
    # roofline: the speed of light of THIS step, every matmul component
    # at the bf16 peak against the device-memory traffic floor
    r = F.train_step_ceiling(cfg, args.bs, t_frames, args.u)
    sol_ms = r["sol_s"] * 1e3
    print(
        f"speed-of-light: {sol_ms:.3f} ms "
        f"(compute {r['compute_sol_s']*1e3:.3f} "
        f"/ bandwidth {r['bandwidth_sol_s']*1e3:.3f}) -> measured is "
        f"{ms / sol_ms:.2f}x SoL; max achievable MFU at this shape "
        f"= {fl / (r['sol_s'] * F.device_peak_flops()) * 100:.1f}%"
    )
    for k, v in r["compute_breakdown_s"].items():
        print(f"  {k:16s} {v*1e3:7.3f} ms")
    return {"ms": ms, "steps": steps, "mfu": m.mfu, "sol_ms": sol_ms,
            "t_frames": t_frames}


if __name__ == "__main__":
    main()
