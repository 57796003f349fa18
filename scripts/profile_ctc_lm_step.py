#!/usr/bin/env python3
"""Device-time profile of one full-width CTC train step and one
full-width LM train step of the port on one GPU.

    python3 scripts/profile_ctc_lm_step.py [--seed 0]

The CTC step is chip_smoke.py's train_ctc_full_width main path
(`ctc_setup`: base.yaml as a CTCModel, N 16, T 49, adamw); the LM step
is train_lm.py's at base.yaml's LM width (embed 1024, hidden 1024, 6
layers, V 2048, dropout 0.3) at the CLI's defaults (bs 768, seq len 64,
lr 1e-2) on the tone corpus's sentences. Each warms up with two steps,
then one step is traced with torch.profiler. Prints one JSON line per
traced step (scripts/profile_transcribe.py's `trace`): host wall time,
summed device kernel time, the device's idle share, kernel launches and
the kernels with the most device time. Labelled with the card's name
and power limit. Needs CUDA.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import torch

    if not torch.cuda.is_available():
        print("profile_ctc_lm_step: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from profile_transcribe import trace

    from libreasr_tpu_torch.config import parse_and_apply_config
    from libreasr_tpu_torch.data.language import get_language
    from libreasr_tpu_torch.models.lm import LM, LMConfig
    from libreasr_tpu_torch.train_lm import (LMTrainer, batch_stream, corpus_ids,
                                             lm_optimizer)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    learner, batches = chip_smoke.ctc_setup(args.seed)
    for b in batches[:2]:  # warm-up: allocator, cuBLAS handles
        learner.step(b)
    trace(lambda: learner.step(batches[2]), "ctc_train_step", card)
    del learner, batches

    lmc = parse_and_apply_config(inference=True)["lm"]
    with tempfile.TemporaryDirectory() as tmp:
        corpus = chip_smoke.write_lm_corpus(os.path.join(tmp, "text.txt"), args.seed)
        ids = corpus_ids(corpus, get_language()[0])
    cfg = LMConfig(vocab_sz=lmc["vocab_sz"], embed_sz=lmc["embed_sz"],
                   hidden_sz=lmc["hidden_sz"], num_layers=lmc["num_layers"], p=0.3)
    trainer = LMTrainer(LM(cfg, seed=0, device="cuda"), lm_optimizer(1e-2, 20))
    stream = batch_stream(ids, 768, 64)
    for _ in range(2):
        trainer.step(*next(stream))
    x, y = next(stream)
    trace(lambda: trainer.step(x, y), "lm_train_step", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
