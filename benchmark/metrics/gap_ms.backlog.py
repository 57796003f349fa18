"""The card's idle milliseconds between chains per engine step, measured
by the program on the card's clock (libreasr_tpu_torch.telemetry): CUDA
events before each chain's first input copy and after its output copy,
for chains dispatched while the trace ran (`engine.gap`). Prints the
gaps' split by the program's innermost span on the host over each gap,
weighted by time, and the traced stretch's idle time beside their sum.
None where the program measures no gaps."""

import sys

LAYER = "device idle between chains"
MOVES = "rt_streams"


def read(ctx):
    try:
        from libreasr_tpu_torch import telemetry
    except ImportError:
        return None
    c = telemetry.snapshot()["counters"]
    steps, gap = c.get("engine.steps"), c.get("engine.gap")
    if not steps or gap is None:
        return None
    split = sorted(((k[len("engine.gap."):], v) for k, v in c.items()
                    if k.startswith("engine.gap.")), key=lambda kv: -kv[1])
    t = ctx.get("trace", {})
    idle = (t["window_s"] - t["busy_s"]) if t.get("window_s") else None
    print(f"# gap_ms.backlog: {gap:.6f} s of gaps over {steps} engine steps "
          f"(the stretch idles {idle} s); split: "
          + ", ".join(f"{k} {v:.6f} s ({100.0 * v / gap if gap else 0.0:.2f}%)"
                      for k, v in split), file=sys.stderr)
    return gap / steps * 1e3
