"""Share of the replays' rows that decode a stream, from the program's
own counters (libreasr_tpu_torch.telemetry) over the traced stretch:
100 x `engine.rows` / (N x `engine.steps`). Prints the masked rows by
cause (a closed slot; an open one with no full step buffered; one whose
backlog ended before the sub-step; one capped by the silence gate), the
rule rows + masked = N x steps, and the engine steps against the graph
replays the trace marks count. None where the program counts no rows."""

import sys

LAYER = "streaming engine batch fill"
MOVES = "rt_streams"
CAUSES = ("inactive", "empty", "short", "gated")


def read(ctx):
    try:
        from libreasr_tpu_torch import telemetry
    except ImportError:
        return None
    c = telemetry.snapshot()["counters"]
    steps, n = c.get("engine.steps"), ctx["traffic"]["streams"]
    if not steps or "engine.rows" not in c:
        return None
    slots = n * steps
    masked = {w: c.get("engine.rows_masked." + w, 0) for w in CAUSES}
    r0, r1 = ctx.get("trace", {}).get("marks", {}).get("replays", (None, None))
    replays = None if r0 is None or r1 is None else r1 - r0
    print(f"# row_fill_pct.backlog: masked rows of {slots} (N {n} x "
          f"{steps} engine steps): "
          + ", ".join(f"{w} {v} ({100.0 * v / slots:.4f}%)"
                      for w, v in masked.items())
          + f"; rows + masked {c['engine.rows'] + sum(masked.values())}; "
          f"graph replays in the stretch {replays}", file=sys.stderr)
    return 100.0 * c["engine.rows"] / slots
