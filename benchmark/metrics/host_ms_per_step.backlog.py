"""Host milliseconds of work in the benchmark's calls into the engine
(append, dispatch, collect, slot churn) over the window, per engine
step. The time the host spends blocked on the card ("wait": the
dispatch in flight before its collect, the chain in flight before a
beam close flushes) is left out, so that a shorter replay does not read
as a host gain."""

LAYER = "streaming engine host side"
MOVES = "rt_streams"
WORK = ("append", "dispatch", "collect", "churn")


def read(ctx):
    steps = ctx["counters"].get("engine_steps")
    if not steps:
        return None
    sp = ctx["spans"].total
    return sum(sp.get(k, 0.0) for k in WORK) / steps * 1e3
