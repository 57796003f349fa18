#!/usr/bin/env python3
"""Device-time profile of one full-width train step of the port on one GPU.

    python3 scripts/profile_train_step.py [--seed 0] [--n 16]

Builds the Learner that chip_smoke.py's train_full_width phase drives:
config/base.yaml with the encoder on its scan cells
(use_pallas_train false), gradient accumulation over 2 batches and a
short schedule, seeded random weights, N ragged 2.5-4 s clips with 20-40
random labels. Warms it up with two steps, then traces two more with
torch.profiler: the first only accumulates its gradients, the second
also runs the optimizer. Prints one JSON line per traced step (as
scripts/profile_transcribe.py does): host wall time, summed device
kernel time, the device's idle share (1 - kernel time / wall time; the
port runs on one stream), kernel launches, and the kernels with the
most device time. Labelled with the card's name and power limit. Needs
CUDA.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=16)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import torch

    if not torch.cuda.is_available():
        print("profile_train_step: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from profile_transcribe import trace

    from libreasr_tpu_torch.training.learner import Learner

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    learner = Learner.from_config(chip_smoke.train_conf(), device="cuda",
                                  seed=args.seed)
    batches = chip_smoke._train_batches(learner.cfg, learner.frontend,
                                        args.seed, n=args.n)
    for b in batches[:2]:  # warm-up: kernel build, allocator, cuBLAS handles
        learner.step(b)
    trace(lambda: learner.step(batches[2]), "train_step_accumulate", card)
    trace(lambda: learner.step(batches[3]), "train_step_update", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
