#!/usr/bin/env python3
"""Times the port's joint kernels F, G and H on one GPU.

    python3 scripts/time_joint_kernels.py [--root DIR] [--seed 0]

Imports libreasr_tpu_torch from DIR (default: the checkout holding this
script), so that two trees can be timed in turns in one process each on
the same card (for example a checkout of the parent commit unpacked
with `git archive` and this one: parent, change, change, parent). Times
with CUDA events, 20 calls after 2 warm-up calls, at the train step's
shape (N 16, T 49, U1 41, J 1024, V 2048, bf16 W_out): F
(joint_lp_fwd), G (joint_lp_dx) and H (joint_lp_dw), each alone, and the
three in a row as the fused loss calls them once a step. A tree whose G
takes the row lse gets F's; an older tree's G makes its own, and H takes
that. Prints one JSON line labelled with the card's name and power
limit. Needs CUDA.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("time_joint_kernels: CUDA is not available", file=sys.stderr)
        return 1
    from libreasr_tpu_torch.ops.kernels import joint_lp as kj

    def ms(fn, reps=20):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator().manual_seed(args.seed)
    n, t, u1, j, v = 16, 49, 41, 1024, 2048

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).cuda()

    enc, pred = rnd(n, t, j, scale=0.5), rnd(n, u1, j, scale=0.5)
    w = rnd(j, v, scale=j ** -0.5).bfloat16()
    b = rnd(v, scale=0.1)
    lab = torch.randint(1, v, (n, u1 - 1), generator=gen).to(torch.int32).cuda()
    gb, ge = rnd(n, t, u1, scale=0.01), rnd(n, t, u1 - 1, scale=0.01)
    g_takes_lse = "lse" in inspect.signature(kj.joint_lp_dx).parameters

    def f():
        return kj.joint_lp_fwd(enc, pred, w, b, lab)

    def g(lse):
        if g_takes_lse:
            return kj.joint_lp_dx(enc, pred, w, b, lab, gb, ge, lse)
        return kj.joint_lp_dx(enc, pred, w, b, lab, gb, ge)

    def step():
        out = f()
        lse = out[2] if g_takes_lse else None
        dx = g(lse)
        if not g_takes_lse:
            lse = dx[2]
        return kj.joint_lp_dw(enc, pred, w, b, lab, gb, ge, lse)

    lse = f()[2] if g_takes_lse else g(None)[2]
    out = {"root": root, "card": card, "g_takes_lse": g_takes_lse,
           "F_ms": ms(f), "G_ms": ms(lambda: g(lse)),
           "H_ms": ms(lambda: kj.joint_lp_dw(enc, pred, w, b, lab, gb, ge, lse)),
           "F_G_H_ms": ms(step)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
