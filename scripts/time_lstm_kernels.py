#!/usr/bin/env python3
"""Times the port's LSTM forward kernels C and D on one GPU.

    python3 scripts/time_lstm_kernels.py [--root DIR] [--seed 0]

Imports libreasr_tpu_torch from DIR (default: the checkout holding this
script), so that two trees can be timed in turns in one process each on
the same card (for example a checkout of the parent commit unpacked
with `git archive` and this one: parent, change, change, parent). Times
with CUDA events, 20 calls after 2 warm-up calls, at the main paths'
shapes: kernel C (lstm_seq_int8) per 74-step call at N 16, H 1024, and
kernel D (lstm_train_fwd) per 49-step call at N 16 with bf16 R at H 1024
and float32 R at H 768 and 64 (the small model's width). Prints one
JSON line labelled with the card's name and power limit. Needs CUDA.
"""

from __future__ import annotations

import argparse
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
        print("time_lstm_kernels: CUDA is not available", file=sys.stderr)
        return 1
    from libreasr_tpu_torch.ops.kernels import lstm as klstm
    from libreasr_tpu_torch.ops.kernels import lstm_train as klt
    from libreasr_tpu_torch.ops.quant import quantize

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

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).cuda()

    out = {"root": root, "card": card}
    n, t, h = 16, 74, 1024
    wx = rnd(n, t, 4 * h)
    r = quantize(rnd(h, 4 * h, scale=h ** -0.5))
    h0, c0 = rnd(n, h, scale=0.5), rnd(n, h, scale=0.5)
    packed = klstm.pack_k4(r.q)
    out["C_n16_t74_h1024_ms"] = ms(lambda: klstm.lstm_seq_int8(
        wx, r.q, r.scale, h0, c0, rq_packed=packed))
    for h, dtype in ((1024, torch.bfloat16), (768, torch.float32),
                     (64, torch.float32)):
        wx = rnd(16, 49, 4 * h)
        rr = rnd(h, 4 * h, scale=h ** -0.5).to(dtype)
        h0, c0 = rnd(16, h, scale=0.5), rnd(16, h, scale=0.5)
        name = f"D_n16_t49_h{h}_{str(dtype).split('.')[-1]}_ms"
        out[name] = ms(lambda: klt.lstm_train_fwd(wx, rr, h0, c0))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
