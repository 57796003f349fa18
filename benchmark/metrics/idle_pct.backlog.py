"""Share of the traced stretch in which no operation ran on the card."""

LAYER = "device"
MOVES = "rt_streams"


def read(ctx):
    t = ctx["trace"]
    if not t.get("window_s") or not t.get("busy_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
