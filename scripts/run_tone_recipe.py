#!/usr/bin/env python3
"""Runs the port's tone recipe at full width on one GPU, instrumented as
chip_smoke.py's train_tone_stream phase, for longer.

    python3 scripts/run_tone_recipe.py [--steps 2000] [--eval-every 500] \
        [--eval-batches 8] [--out DIR]

config/base.yaml with the recipe's settings and seed (libreasr_tpu_torch.
scripts.train_tone_stream), a BPE tokenizer of 64 trained by the port, the
ladder from the sampled histogram; dev WER and CER at every eval, the
best-WER bundle's test WER greedy and with beam search (K 4) by length,
step ms (median, p90), the host's wait for each batch and its share of
the loop, kernel launches and peak memory: one JSON line, after the
card's name and power limit (nvidia-smi). The checkpoints and the
bundle go to --out (default: a temporary directory, removed). Needs
CUDA.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--eval-batches", type=int, default=8)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("run_tone_recipe: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as c

    card = c.phase_device()
    c.phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        c.phase_train_tone_stream(
            card, args.out or tmp, steps=args.steps,
            eval_every=args.eval_every, eval_batches=args.eval_batches,
            phase="tone_recipe")
    return 0


if __name__ == "__main__":
    sys.exit(main())
