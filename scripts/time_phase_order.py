"""Times phases of chip_smoke.py run in a given order in one process, to
see whether a phase slows the ones after it (the card's state, the
allocator, the host).

    python scripts/time_phase_order.py [--root DIR] [--seed 0] PHASE [PHASE ...]

PHASE is one of
  options_full_width, options_train_full_width   chip_smoke.py's phases
  tone       train_tone_stream, then evaluate_wer on its bundle
  release    gc.collect() and torch.cuda.empty_cache()
--root names the checkout whose chip_smoke.py and package run (default:
the one that holds this script), so that another commit's phases can be
timed in the same machine call. The kernels are built first, untimed.

A host yardstick, a fixed pure-Python loop (median of 3, ms), is taken
before the first phase and after the last: it moves with the host's CPU
and with nothing on the card. The last line is one JSON object: the
card, the order, each phase's seconds, the tone phase's step and
batch-wait medians and host-wait share, and the two yardsticks.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import statistics
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("options_full_width", "options_train_full_width", "tone", "release")


def yardstick_ms() -> float:
    def once() -> float:
        t0 = time.perf_counter()
        sum(i * i for i in range(2_000_000))
        return (time.perf_counter() - t0) * 1e3

    return statistics.median(once() for _ in range(3))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("phases", nargs="+", choices=PHASES)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    smoke = importlib.import_module("chip_smoke")
    import torch

    if not torch.cuda.is_available():
        print("time_phase_order: CUDA is not available", file=sys.stderr)
        return 1
    logged = {}
    real_log = smoke.log

    def keep(phase, **kw):
        logged[phase] = kw
        real_log(phase, **kw)

    smoke.log = keep
    card = smoke.phase_device()
    smoke.phase_build()
    torch.cuda.synchronize()
    out = {"card": card, "root": root, "order": args.phases,
           "yardstick_ms_before": yardstick_ms(), "seconds": []}
    for name in args.phases:
        t0 = time.perf_counter()
        if name == "tone":
            with tempfile.TemporaryDirectory() as tmp:
                smoke.phase_evaluate_wer(args.seed,
                                         smoke.phase_train_tone_stream(card, tmp))
        elif name == "release":
            gc.collect()
            torch.cuda.empty_cache()
        else:
            getattr(smoke, "phase_" + name)(args.seed, card)
        torch.cuda.synchronize()
        out["seconds"].append([name, time.perf_counter() - t0])
    out["yardstick_ms_after"] = yardstick_ms()
    tone = logged.get("train_tone_stream")
    if tone:
        out["tone"] = {k: tone[k] for k in (
            "step_ms_median", "step_ms_p90", "batch_wait_ms_median",
            "host_wait_share", "window_fill_ms_sum")}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
