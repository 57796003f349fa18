"""The LSTM transducer family (model.name "Transducer"): LibreASR's
6-2-1024 net as the port serves it, an LSTM encoder with a batch norm
after every layer, an NBRC predictor, the concat joint, and, where the
configuration enables it, the LSTM LM fused in beam search.

Found by the configuration's `model.name` (`core.family`); the names a
family defines are listed in `benchmark/core.py`.
"""

from __future__ import annotations

import copy
import math

from benchmark import flops as FL
from benchmark import weights as W
from benchmark.reference.model import LM, Transducer

# where the configuration's pinned blank bias is written: the joint's
# blank logit
BLANK_LEAF = ("model.joint.out.bias", 0)

# the engine's chunk: 80 ms of audio, one stacked frame
CHUNK_S = 0.08


def plan(conf: dict) -> list[tuple]:
    """[(name, shape, mean, std)] of the transducer ("model.*") and, when
    the configuration has one, its LM ("lm.*"), by the program's leaf
    names. mean "forget": an LSTM bias, 0 but 1 on the forget gate (gate
    order i, g, f, o)."""
    m = conf["model"]
    f, e, v = m["feature_sz"], m["embed_sz"], m["vocab_sz"]
    h, o, j = m["hidden_sz"], m["out_sz"], m["joint_sz"]
    if m["encoder"]["rnn_type"] != "LSTM" or m["predictor"]["rnn_type"] != "NBRC":
        raise ValueError("the plan covers an LSTM encoder and an NBRC predictor")
    if h != o or m["joint"]["method"] != "concat":
        raise ValueError("the plan covers hidden_sz == out_sz and the concat joint")
    out = [("model.encoder.input_norm.scale", (f,), 1.0, W.SMALL),
           ("model.encoder.input_norm.bias", (f,), 0.0, W.SMALL)]
    for i in range(m["encoder"]["num_layers"]):
        p = f"model.encoder.rnn_stack.layer{i}"
        out += W.lstm_leaves(p + ".cell", f if i == 0 else h, h)
        out.append((p + ".h0", (2, 1, h), 0.0, W.SMALL))
        out += W.norm_leaves(f"model.encoder.rnn_stack.norm{i}", h)
    out.append(("model.predictor.embed.embedding", (v, e), 0.0, 1 / math.sqrt(e)))
    if e != h:
        out += [("model.predictor.ffn.kernel", (e, h), 0.0, 1 / math.sqrt(e)),
                ("model.predictor.ffn.bias", (h,), 0.0, W.SMALL)]
    for i in range(m["predictor"]["num_layers"]):
        p = f"model.predictor.rnn_stack.layer{i}"
        out += W.gru_leaves(p + ".cell", h, h)
        out.append((p + ".h0", (1, 1, h), 0.0, W.SMALL))
        out += W.norm_leaves(f"model.predictor.rnn_stack.norm{i}", h)
    out += [("model.joint.pred_proj.kernel", (o, j), 0.0, 1 / math.sqrt(o)),
            ("model.joint.pred_proj.bias", (j,), 0.0, W.SMALL),
            ("model.joint.enc_proj.kernel", (o, j), 0.0, 1 / math.sqrt(o)),
            ("model.joint.out.kernel", (j, v), 0.0, 1 / math.sqrt(j)),
            ("model.joint.out.bias", (v,), 0.0, W.SMALL)]
    lm = conf.get("lm") or {}
    if lm.get("enable"):
        le, lh = lm["embed_sz"], lm["hidden_sz"]
        out.append(("lm.embed.embedding", (lm["vocab_sz"], le), 0.0,
                    1 / math.sqrt(le)))
        for i in range(lm["num_layers"]):
            out += W.lstm_leaves(f"lm.lstm{i}", le if i == 0 else lh, lh)
        if le != lh:
            out += [("lm.out.kernel", (lh, lm["vocab_sz"]), 0.0, 1 / math.sqrt(lh)),
                    ("lm.out.bias", (lm["vocab_sz"],), 0.0, W.SMALL)]
    return out


def build(conf: dict, leaves: dict, device):
    """The program's bundle at the configuration, with the benchmark's
    weights copied into its model (and LM)."""
    from libreasr_tpu_torch.api import ASRBundle
    from libreasr_tpu_torch.data.language import get_language
    from libreasr_tpu_torch.models.lm import LM as ProgramLM
    from libreasr_tpu_torch.models.lm import LMConfig
    from libreasr_tpu_torch.models.transducer import Transducer as Program
    from libreasr_tpu_torch.models.transducer import TransducerConfig

    model = Program(TransducerConfig.from_config(conf), device=device)
    W.load_into(model, leaves, "model")
    lm = None
    if (conf.get("lm") or {}).get("enable"):
        lm = ProgramLM(LMConfig.from_config(conf), device=device)
        W.load_into(lm, leaves, "lm")
    lang, _ = get_language()
    return ASRBundle(conf, model, lang, device, lm)


def reference(leaves: dict, conf: dict, prec=None):
    """The plain reference's (transducer, LM or None) over the leaves;
    with `prec` (the control) the transducer's products at that
    precision and the float32 LM's one step down, in bf16."""
    lm = None
    if (conf.get("lm") or {}).get("enable"):
        lm = LM(leaves, conf, "bf16" if prec else None)
    return Transducer(leaves, conf, prec), lm


def geometry(conf: dict) -> dict:
    """The frontend's stacking (10 log-mel frames, stride 8) and the
    special ids: bos starts the predictor, blank ends a frame, eos
    latches a stream."""
    return {"n_stack": 10, "downsample": 8, "bos": 2, "blank": 0, "eos": 2}


def flops(conf: dict) -> dict:
    """FLOPs of one stream (`benchmark/flops`): "frame", the frontend
    over a chunk of `chunk_s` seconds and the encoder on its frame;
    "eval", one predictor step and one joint evaluation; "lm_token", the
    LM on one token (0 without an LM)."""
    m = conf["model"]
    lm = conf.get("lm") or {}
    chunk = int(conf["sr"] * CHUNK_S)
    return {"frame": FL.frontend_chunk(conf, chunk) + FL.encoder_frame(m),
            "eval": FL.predictor_token(m) + FL.joint_single(m),
            "lm_token": FL.lm_token(lm) if lm.get("enable") else 0.0,
            "chunk_s": CHUNK_S}


def tiny(config: dict) -> dict:
    """A copy of the configuration with its widths and depths shrunk to a
    size the CPU runs in seconds (the CPU tests only)."""
    c = copy.deepcopy(config)
    conf = c["conf"]
    conf["melkwargs"]["n_mels"] = 16
    conf["model"].update(feature_sz=160, embed_sz=24, hidden_sz=32, out_sz=32,
                         joint_sz=32, vocab_sz=64)
    conf["model"]["encoder"]["num_layers"] = 2
    if (conf.get("lm") or {}).get("enable"):
        conf["lm"].update(vocab_sz=64, embed_sz=16, hidden_sz=16, num_layers=2)
    return c
