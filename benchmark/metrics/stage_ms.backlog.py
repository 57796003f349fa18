"""Host milliseconds of the engine's input staging per engine step, from
the program's own spans (libreasr_tpu_torch.telemetry) over the traced
stretch: the dispatch's gather (the availability and silence-gate
arithmetic, the chunk array, the per-row copies from the host ring),
the wire encode and the staging (from_numpy, pin_memory, the pinned
output). Prints each part. None where the program records no such
spans."""

import sys

LAYER = "streaming engine host side: input staging"
MOVES = "rt_streams"
PARTS = ("engine.dispatch.gather", "engine.dispatch.encode",
         "engine.dispatch.stage")


def read(ctx):
    try:
        from libreasr_tpu_torch import telemetry
    except ImportError:
        return None
    snap = telemetry.snapshot()
    steps, spans = snap["counters"].get("engine.steps"), snap["spans"]
    if not steps or not any(p in spans for p in PARTS):
        return None
    ms = {p: spans[p]["total_s"] / steps * 1e3 if p in spans else 0.0
          for p in PARTS}
    print("# stage_ms.backlog: per engine step over " + str(steps) + " steps: "
          + ", ".join(f"{p} {v:.6f} ms" for p, v in ms.items()),
          file=sys.stderr)
    return sum(ms.values())
