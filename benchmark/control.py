"""Readings on the chip that set a cell's pinned numbers; the benchmark's
own runs never run them.

    python3 -m benchmark.control rate --workload <cell> --seeds 1,2 \\
        --biases 0,1,2 [--gain 8] [--seconds 3]

runs the cell's engine and traffic, a FRESH engine for every candidate
blank bias, and prints the tokens it emitted a chunk: the blank bias a
configuration pins is the one at which fresh engines emit near the
trained golden bundle's rate.

    python3 -m benchmark.control calibrate --workload <cell> --seeds 1,2,3 \
        --biases LO,HI [--gain 16] [--target 0.4615] [--seconds 3]

bisects the blank bias between LO (emits more than the target) and HI
(less), a fresh engine for every candidate on the first seed, and then
reads the rate at the bias it settles on with every other seed.

    python3 -m benchmark.control readings --workload <cell> --seeds 1,2,3 \\
        [--seconds 10]

runs the cell as a benchmark run does and prints, for every seed, the
check's numbers for the program and for the control: the plain
reference in the program's place, its matrix products in float8 e4m3
(bfloat16 for the parts the configuration runs in float32), the next
precision below the configuration's. A limit lies between the largest
of the program's readings and the smallest of the control's.

One JSON line a reading, on standard output.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from benchmark import core  # noqa: E402
from benchmark.run import Bench  # noqa: E402


def _emit(row: dict) -> None:
    print(json.dumps(row), flush=True)


def rate(bench: Bench, seconds: float) -> dict:
    """A fresh engine at the bench's weights: tokens a chunk it emits
    over `seconds` of the cell's traffic."""
    drv = bench.generator()
    t0 = time.perf_counter()
    drv.setup()
    setup = time.perf_counter() - t0
    drv.window(seconds)
    drv.release()
    c = drv.counters
    return {"tokens_per_chunk": c["tokens_per_chunk"], "frames": c["frames"],
            "setup_s": setup, "rt_streams": c["audio_s"] / c["window_s"]}


def readings(bench: Bench, seconds: float, program_tf32: bool = False) -> dict:
    """The check's numbers of the program and of the control at one
    seed. program_tf32: the program runs with TF32 switched on (the
    control of a float32 configuration: the program's own path one
    precision down); the reference judges with it off."""
    import torch

    import libreasr_tpu_torch  # noqa: F401  (its import turns TF32 off)

    tf32 = torch.backends.cuda.matmul, torch.backends.cudnn
    for b in tf32:
        b.allow_tf32 = program_tf32
    drv = bench.generator()
    drv.setup()
    drv.window(seconds)
    drv.release()
    for b in tf32:
        b.allow_tf32 = False
    prog, faults = drv.judge_numbers()
    if program_tf32:
        return {"program_tf32": prog, "faults": faults,
                "tokens_per_chunk": drv.counters["tokens_per_chunk"],
                "finished": drv.counters["finished"]}
    ctrl, cfaults = drv.judge_numbers(prec="fp8")
    return {"program": prog, "control": ctrl, "faults": faults + cfaults,
            "tokens_per_chunk": drv.counters["tokens_per_chunk"],
            "finished": drv.counters["finished"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("rate", "calibrate", "readings"))
    ap.add_argument("--target", type=float, default=0.4615)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--biases", default="")
    ap.add_argument("--gain", type=float, default=None)
    ap.add_argument("--weight-seed", type=int, default=None)
    ap.add_argument("--program-tf32", action="store_true")
    ap.add_argument("--compute", default=None,
                    help="the towers' compute dtype in place of the configuration's")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("benchmark.control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = core.load_json("workloads", args.workload)
    base = core.load_json("configs", cell["config"])
    seeds = [int(s) for s in args.seeds.split(",")]
    biases = ([float(b) for b in args.biases.split(",")] if args.biases
              else [base["blank_bias"]])
    card = core.power_limit()

    def one(what, seed, bias):
        conf = copy.deepcopy(base)
        conf["blank_bias"] = bias
        if args.gain is not None:
            conf["gain"] = {"model.joint.out.kernel": args.gain}
        if args.weight_seed is not None:
            conf["weight_seed"] = args.weight_seed
        if args.compute:
            conf["conf"]["dtypes"]["compute"] = args.compute
        bench = Bench(args.workload, seed, "cuda", config=conf)
        row = {"what": what, "workload": args.workload, "seed": seed,
               "bias": bias, "gain": conf.get("gain"),
               "weight_seed": conf.get("weight_seed"), "card": card}
        if what == "readings":
            row.update(readings(bench, args.seconds, args.program_tf32))
        else:
            row.update(rate(bench, args.seconds))
        _emit(row)
        del bench
        torch.cuda.empty_cache()
        return row

    if args.what == "calibrate":
        lo, hi = biases
        best = None
        for _ in range(12):
            mid = 0.5 * (lo + hi)
            r = one("calibrate", seeds[0], mid)["tokens_per_chunk"]
            if best is None or abs(r - args.target) < abs(best[1] - args.target):
                best = (mid, r)
            if abs(r - args.target) <= 0.1 * args.target:
                break
            lo, hi = (mid, hi) if r > args.target else (lo, mid)
        for seed in seeds[1:]:
            one("rate", seed, best[0])
        return 0
    for seed in seeds:
        for bias in biases:
            one(args.what, seed, bias)
    return 0


if __name__ == "__main__":
    sys.exit(main())
