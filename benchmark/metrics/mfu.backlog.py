"""The whole step's share of the card's peak for the configuration's
compute type over the window: the FLOPs the inputs needed (frontend and
encoder every chunk; the predictor and joint at 1 + tokens emitted
evaluations a decoded frame, times the beam's width, with the LM's step
in beam mode; each count from the configuration's family), not the
masked rounds the captured step runs, over the window's seconds.
bfloat16 towers are held to the bfloat16 peak; float32 towers, which
the configurations run with TF32 off, to the float32 peak."""

import sys

from benchmark import core
from benchmark import flops as FL

LAYER = "whole step"
MOVES = "rt_streams"
PEAK_OF = {"bfloat16": "bfloat16", "float32": "float32"}


def read(ctx):
    c = ctx["counters"]
    if not c.get("frames") or not c.get("window_s"):
        return None
    conf = ctx["config"]["conf"]
    dec = ctx["config"]["decoding"]
    f = core.family(conf).flops(conf)
    k = max(dec["beam_width"], 1)
    evals = k * (c["frames"] + c["tokens"])
    per_eval = f["eval"]
    if dec["use_lm"]:
        per_eval += f["lm_token"]
    flops = c["frames"] * f["frame"] + evals * per_eval
    kind = PEAK_OF[conf["dtypes"]["compute"]]
    peak = FL.peaks(ctx["device_name"])[kind]
    print(f"# mfu.backlog: {flops!r} FLOPs ({c['frames']} frames of "
          f"{f['chunk_s']} s) in {c['window_s']:.6f} s against the {kind} peak "
          f"{peak:.6g} FLOP/s of {ctx['device_name']}", file=sys.stderr)
    return 100.0 * flops / c["window_s"] / peak
