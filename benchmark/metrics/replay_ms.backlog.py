"""Device milliseconds of one engine step: the kernel time in the traced
stretch over the CUDA graph replays enqueued in it (the device is
drained at both ends of the stretch)."""

LAYER = "streaming engine step"
MOVES = "rt_streams"


def read(ctx):
    t = ctx["trace"]
    r0, r1 = t["marks"].get("replays", (None, None))
    if not t.get("kernel_s") or r0 is None or r1 is None or r1 <= r0:
        return None
    return t["kernel_s"] / (r1 - r0) * 1e3
