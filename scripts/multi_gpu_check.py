#!/usr/bin/env python3
"""The port's multi-GPU paths across distinct cards, on a host with two
or more. chip_smoke.py, on one card, starts NCCL on a world of one rank
and runs a mesh engine over two sub-engines of one card; this script
runs both across cards.

    python3 scripts/multi_gpu_check.py [--seed 0] [--steps 3]

1. train: one process a card (an even number of them), NCCL over
   tcp://127.0.0.1 on a free port, and four meshes over the same world
   in turn: data W; data W/2 x model 2; data W/2 x pipe 2 (with --pp's
   overrides: encoder norm none, no state carry, the fused loss; 2
   microbatches), all in float32; and data W in base.yaml's bfloat16.
   On each, a Learner at config/base.yaml's width with SGD (lr 1e-2, no
   accumulation) steps on its rows of chip_smoke.py's training batches
   (N 16), against the single-process Learner on the global batch on
   the same card. In float32 (the encoder on its scan cells: R of H
   1024 exceeds kernel D's limit, as in JAX) every step's loss within
   rtol 1e-5 (pipe: 2e-4), then every parameter and batch statistic
   within rtol 3e-4, atol 1e-5, the bounds the CPU tests hold gloo ranks
   to; the mesh step launches F, G, H once. In bfloat16 the mesh step
   launches D, E 6 times and F, G, H once, as the plain step, and is
   held to loss rtol 1e-3 and parameters rtol 1e-2, atol 1e-4: products
   over 16/W rows and over 16 take other kernels (the frontend's float32
   DFT splits K at one batch and not at another, 1.1e-5 apart on an
   H100), and bf16 rounds such differences at 2^-8. Logs the step ms of
   both, the launches and the NCCL version.
2. streaming_mesh: chip_smoke.py's phase with its mesh over every
   visible card (one sub-engine, weights copy and CUDA graph a card).

Prints the cards' names and power limits, one line a check, and exits 1
if one fails (2 with fewer than two cards). Every rank has a time limit.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOINT = {"joint_lp_fwd": 1, "joint_lp_dx": 1, "joint_lp_dw": 1}
# (name, mesh axes for a world of W, pipe overrides, compute type,
#  (loss rtol, parameter rtol, parameter atol), launches a mesh step)
SCENARIOS = (
    ("data", lambda w: dict(data=w), False, "float32", (1e-5, 3e-4, 1e-5),
     JOINT),
    ("data_model", lambda w: dict(data=w // 2, model=2), False, "float32",
     (1e-5, 3e-4, 1e-5), JOINT),
    ("data_pipe", lambda w: dict(data=w // 2, pipe=2), True, "float32",
     (2e-4, 3e-4, 1e-5), JOINT),
    ("data_bf16", lambda w: dict(data=w), False, "bfloat16", (1e-3, 1e-2, 1e-4),
     {**JOINT, "lstm_train_fwd": 6, "lstm_train_bwd": 6}),
)


def _conf(pp: bool, compute: str) -> dict:
    import chip_smoke

    conf = chip_smoke.train_conf(accumulate=1)
    conf["dtypes"]["compute"] = compute
    conf["training"].update(optimizer="sgd", lr=1e-2)
    if pp:  # what train.py sets for --pp
        conf["model"]["encoder"]["norm"] = "none"
        conf["model"]["encoder"]["use_tmp_state_pcent"] = 0.0
        conf.setdefault("loss", {})["fused"] = True
    return conf


def _param_gap(whole: dict, want: dict, rtol: float, atol: float) -> dict:
    """The largest |a - b|, and the largest excess over atol + rtol |b|
    (<= 0 within the bounds), over every tensor, with its name."""
    worst, excess, name = 0.0, -float("inf"), None
    for n, b in want.items():
        d = (whole[n].double() - b.double()).abs()
        e = float((d - (atol + rtol * b.double().abs())).max())
        worst = max(worst, float(d.max()))
        if e > excess:
            excess, name = e, n
    return dict(max_abs=worst, max_excess=excess, worst_tensor=name,
                tensors=len(want), same_names=sorted(whole) == sorted(want))


def rank_main(args) -> int:
    sys.path.insert(0, HERE)
    import chip_smoke
    import torch
    import torch.distributed as tdist

    from libreasr_tpu_torch.parallel import distributed as dist
    from libreasr_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from libreasr_tpu_torch.training.learner import Learner

    dist.initialize(f"127.0.0.1:{args.port}", args.world, args.rank,
                    device="cuda", timeout_s=300)
    results = []
    try:
        for name, axes, pp, compute, (loss_rtol, rtol, atol), want in SCENARIOS:
            conf = _conf(pp, compute)
            mesh = make_mesh(**axes(args.world))
            plain = Learner.from_config(copy.deepcopy(conf), device="cuda",
                                        seed=args.seed)
            meshed = Learner.from_config(copy.deepcopy(conf), device="cuda",
                                         seed=args.seed, mesh=mesh, pp_micro=2)
            batches = chip_smoke._train_batches(plain.cfg, plain.frontend,
                                                args.seed, steps=args.steps)
            steps = []
            for b in batches:
                lp, msp, _ = chip_smoke._timed_step(plain, b)
                local = dist.global_batch(mesh, shard_batch(mesh, b), "cuda")
                lm, msm, launches = chip_smoke._timed_step(meshed, local)
                steps.append(dict(loss_plain=lp, loss_mesh=lm, ms_plain=msp,
                                  ms_mesh=msm, launches_mesh=launches))
            gap = _param_gap(meshed.state_dict(), plain.model.state_dict(),
                             rtol, atol)
            loss_ok = all(abs(s["loss_mesh"] - s["loss_plain"])
                          <= loss_rtol * abs(s["loss_plain"]) for s in steps)
            launches_ok = all(s["launches_mesh"] == want for s in steps)
            results.append(dict(
                check=name, mesh=mesh.shape, compute=compute, rank=args.rank,
                world=args.world, device=str(torch.cuda.current_device()),
                rows=len(local[0]), bounds=[loss_rtol, rtol, atol],
                expected_launches=want, steps=steps, params=gap,
                ok=loss_ok and launches_ok and gap["same_names"]
                and gap["max_excess"] <= 0))
            del plain, meshed
            torch.cuda.empty_cache()
        results.append(dict(check="nccl", backend=tdist.get_backend(),
                            version=".".join(map(str, torch.cuda.nccl.version())),
                            ok=True))
    finally:
        tdist.destroy_process_group()
    with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
        json.dump(results, f)
    return 0


def _train(args, world: int) -> list:
    import chip_smoke

    with tempfile.TemporaryDirectory() as out:
        cmd = [sys.executable, os.path.abspath(__file__), "--seed", str(args.seed),
               "--steps", str(args.steps), "--world", str(world), "--port",
               str(chip_smoke._free_port()), "--out", out]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=HERE)
                 for r in range(world)]
        try:
            codes = [p.wait(timeout=args.timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            raise RuntimeError(f"multi_gpu_check: rank exit codes {codes}")
        return [json.load(open(os.path.join(out, f"rank{r}.json")))
                for r in range(world)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds each training rank may take")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        return rank_main(args)
    sys.path.insert(0, HERE)
    import torch

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < 2:
        print(f"multi_gpu_check: needs two or more CUDA devices, found {count}",
              file=sys.stderr)
        return 2
    import chip_smoke

    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    for line in cards:
        print(line, flush=True)
    chip_smoke.phase_build()
    ok = True
    for rank in _train(args, count - count % 2):
        for r in rank:
            print("train: " + json.dumps(r, sort_keys=True), flush=True)
            ok = ok and r["ok"]
    devices = [f"cuda:{i}" for i in range(count)]
    chip_smoke.phase_streaming_mesh(args.seed, "; ".join(cards), devices=devices)
    print(json.dumps({"ok": ok, "cards": count}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
