#!/usr/bin/env python3
"""Device-time profile of one full-width train step of the port on one GPU.

    python3 scripts/profile_train_step.py [--seed 0] [--n 16] [--scan] [--mesh]

Builds the Learner that chip_smoke.py's train_full_width phase drives:
config/base.yaml with the encoder's LSTM layers on kernels D and E
(with --scan: on its scan cells, use_pallas_train false), gradient
accumulation over 2 batches and a short schedule, seeded random weights,
N ragged 2.5-4 s clips with 20-40 random labels. With --mesh the
Learner runs on make_mesh(data=1) over an NCCL group of one rank, as
chip_smoke.py's dist_train_full_width phase builds it. Warms it up with two steps, then traces two more with
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
    ap.add_argument("--scan", action="store_true",
                    help="the encoder on its scan cells, not kernels D, E")
    ap.add_argument("--mesh", action="store_true",
                    help="the Learner on a data-1 mesh over one NCCL rank")
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
    mesh = None
    if args.mesh:
        from libreasr_tpu_torch.parallel.mesh import make_mesh

        chip_smoke._nccl_world_of_one()
        mesh = make_mesh(data=1)
    learner = Learner.from_config(
        chip_smoke.train_conf(use_train_kernel=not args.scan), device="cuda",
        seed=args.seed, mesh=mesh)
    batches = chip_smoke._train_batches(learner.cfg, learner.frontend,
                                        args.seed, n=args.n)
    for b in batches[:2]:  # warm-up: kernel build, allocator, cuBLAS handles
        learner.step(b)
    route = ("scan" if args.scan else "d_e") + ("_mesh" if args.mesh else "")
    trace(lambda: learner.step(batches[2]), f"train_step_accumulate_{route}", card)
    trace(lambda: learner.step(batches[3]), f"train_step_update_{route}", card)
    if args.mesh:
        import torch.distributed as tdist

        tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
