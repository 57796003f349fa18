#!/usr/bin/env python3
"""Device-time profile of the port's streaming step on one GPU.

    python3 scripts/profile_stream_step.py [--seed 0] [--n 64 512] [--float32]

Builds the full-width model of config/base.yaml with seeded random
weights (as chip_smoke.py does) and, for each N, a StreamingEngine
(its step captured as one CUDA graph). Traces with torch.profiler one
step of the uncaptured step function (`engine.step_fn`, called
directly) and 10 replays of the graph. Prints one JSON line per traced
call: host wall time, summed device kernel time, the device's idle
share (1 - kernel time / wall time; one stream, so kernels do not
overlap), kernel launches, and the kernels with the most device time,
grouped by name. Labelled with the card's name and power limit. Needs
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
    ap.add_argument("--n", type=int, nargs="+", default=[64, 512])
    ap.add_argument("--float32", action="store_true",
                    help="float32 transfer (default: int16, the server's)")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_stream_step: CUDA is not available", file=sys.stderr)
        return 1
    from profile_transcribe import trace

    from libreasr_tpu_torch.api import ASRBundle
    from libreasr_tpu_torch.config import parse_and_apply_config
    from libreasr_tpu_torch.models.streaming import StreamingConfig, StreamingEngine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    bundle = ASRBundle.from_config(parse_and_apply_config(inference=True),
                                   seed=args.seed, device="cuda")
    scfg = StreamingConfig(sr=bundle.frontend.sr, transfer_dtype=(
        "float32" if args.float32 else "int16"))
    rng = np.random.default_rng(args.seed)
    for n in args.n:
        eng = StreamingEngine(bundle, n_streams=n, scfg=scfg)
        chunks = (rng.standard_normal((n, 1, scfg.chunk_samples)) * 0.1
                  ).astype(np.float32)
        for _ in range(3):  # past the reset step, allocator warm
            eng.step_batch(chunks)
        wire = torch.from_numpy(eng._encode_chunks(chunks)).cuda()
        valid = torch.ones(n, dtype=torch.bool, device="cuda")
        reset = torch.zeros(n, dtype=torch.bool, device="cuda")
        state = eng.state.clone()

        def eager():
            with torch.no_grad():
                eng.step_fn(state, wire, valid, reset)

        def replays():
            for _ in range(10):
                eng._graph.replay()

        eager()
        trace(eager, f"eager_step_n{n}", card)
        trace(replays, f"graph_replay_x10_n{n}", card)
        del eng
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
