"""The whole step's share of the card's peak for the configuration's
compute type over the window: the FLOPs the inputs needed (frontend and
encoder every chunk; the predictor and joint at 1 + tokens emitted
evaluations a decoded frame, times the beam's width, with the LM's step
in beam mode), not the masked rounds the captured step runs, over the
window's seconds. bfloat16 towers are held to the bfloat16 peak;
float32 towers, which the configurations run with TF32 off, to the
float32 peak."""

import sys

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
    m = conf["model"]
    chunk = int(conf["sr"] * 0.08)
    k = max(dec["beam_width"], 1)
    evals = k * (c["frames"] + c["tokens"])
    per_eval = FL.predictor_token(m) + FL.joint_single(m)
    if dec["use_lm"]:
        per_eval += FL.lm_token(conf["lm"])
    flops = (c["frames"] * (FL.frontend_chunk(conf, chunk) + FL.encoder_frame(m))
             + evals * per_eval)
    kind = PEAK_OF[conf["dtypes"]["compute"]]
    peak = FL.peaks(ctx["device_name"])[kind]
    print(f"# mfu.backlog: {flops:.6g} FLOPs in {c['window_s']:.6f} s against "
          f"the {kind} peak {peak:.6g} FLOP/s of {ctx['device_name']}",
          file=sys.stderr)
    return 100.0 * flops / c["window_s"] / peak
