#!/usr/bin/env python3
"""Device-time profile of the port's transcribe_batch on one GPU.

    python3 scripts/profile_transcribe.py [--seed 0] [--n 16] [--seconds 6] [--int8]

Builds the full-width model of config/base.yaml with seeded random
weights (as chip_smoke.py does; with --int8, its towers quantized by
ASRBundle.quantize), warms it up, then traces one
transcribe_batch and one encode with torch.profiler. Prints one JSON
line per traced call: host wall time, summed device kernel time, the
device's idle share (1 - kernel time / wall time; the port runs on one
stream, so kernels do not overlap), kernel launches, and the kernels
with the most device time, and the host operators with the most self
time. Labelled with the card's name and power
limit. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def trace(fn, label: str, card: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(_device_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[:8]
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    print(json.dumps({
        "call": label, "card": card, "wall_ms": wall_ms,
        "device_kernel_ms": dev_ms,
        "idle_share": 1.0 - dev_ms / wall_ms if dev_ms else None,
        "kernel_launches": sum(e.count for e in kernels),
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "ms": _device_us(e) / 1e3} for e in top],
        "top_host_ops": [{"name": e.key[:80], "count": e.count,
                          "self_ms": e.self_cpu_time_total / 1e3}
                         for e in host[:8]],
    }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--int8", action="store_true",
                    help="quantize the towers (int8 cells, kernel C)")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_transcribe: CUDA is not available", file=sys.stderr)
        return 1
    from libreasr_tpu_torch.api import ASRBundle
    from libreasr_tpu_torch.config import parse_and_apply_config
    from libreasr_tpu_torch.ops.frontend import features_batch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    bundle = ASRBundle.from_config(parse_and_apply_config(inference=True),
                                   seed=args.seed, device="cuda")
    if args.int8:
        bundle.quantize()
    sr = bundle.frontend.sr
    rng = np.random.default_rng(args.seed)
    s = int(args.seconds * sr)
    lengths = rng.integers(s // 2, s + 1, args.n)
    lengths[0] = s
    audio = (rng.standard_normal((args.n, s)) * 0.1).astype(np.float32)
    audio *= np.arange(s)[None, :] < lengths[:, None]
    with torch.inference_mode():
        feats, flens = features_batch(torch.from_numpy(audio).cuda(),
                                      torch.from_numpy(lengths).cuda(),
                                      bundle.frontend)
    for _ in range(2):  # warm-up: kernel build, allocator, cuBLAS handles
        bundle.transcribe_batch(audio, lengths)
    tag = "_int8" if args.int8 else ""
    trace(lambda: bundle.transcribe_batch(audio, lengths),
          "transcribe_batch" + tag, card)
    trace(lambda: bundle.encode(feats, flens), "encode" + tag, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
