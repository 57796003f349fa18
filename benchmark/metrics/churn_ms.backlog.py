"""Host milliseconds of slot turnover per engine step, from the
program's own spans (libreasr_tpu_torch.telemetry) over the traced
stretch: `engine.finish_slot`, `engine.flush_slot`, `engine.close_slot`
and `engine.open_slot` where no other of the four holds them (a close
flushes: counted once). Prints the flush's device reads
(`engine.flush_slot.read`), which wait for the chain in flight. None
where the program records no such spans."""

import sys

LAYER = "streaming engine slot turnover"
MOVES = "rt_streams"
CHURN = ("engine.finish_slot", "engine.flush_slot", "engine.close_slot",
         "engine.open_slot")


def read(ctx):
    try:
        from libreasr_tpu_torch import telemetry
    except ImportError:
        return None
    snap = telemetry.snapshot()
    steps, spans = snap["counters"].get("engine.steps"), snap["spans"]
    if not steps or not any(n in spans for n in CHURN):
        return None
    top = sum(sp["total_s"] - sum(s for p, s in sp["parents"].items()
                                  if p in CHURN)
              for n in CHURN if (sp := spans.get(n)) is not None)
    read_ = spans.get("engine.flush_slot.read", {"total_s": 0.0, "count": 0})
    print(f"# churn_ms.backlog: {read_['count']} flush reads, "
          f"{read_['total_s'] / steps * 1e3:.6f} ms per engine step; "
          + ", ".join(f"{n} {spans[n]['count']}" for n in CHURN if n in spans),
          file=sys.stderr)
    return top / steps * 1e3
