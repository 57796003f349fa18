"""The model's weights, made from the seed on the device.

`plan(conf)` lists every leaf of the configured model by the name the
program gives it (its flax-style parameter and buffer names), with the
distribution it is drawn from. `draw` makes all of them from ONE normal
draw on the device, so that set-up makes 70 million weights in one call.
The program's model and the plain reference both take these leaves: the
benchmark makes them, and neither side derives them from the other.

Matrices are drawn at the scale of the program's own initialisers
(Xavier-uniform's and LeCun-normal's standard deviations); biases,
initial states, norm scales and batch-norm statistics are drawn too, so
that the check covers every leaf and not only the matrices.
"""

from __future__ import annotations

import math

import torch

# (mean, std) of the small leaves
SMALL = 0.1


def _xavier_std(fan_in: int, fan_out: int) -> float:
    return math.sqrt(2.0 / (fan_in + fan_out))


def _norm_leaves(prefix: str, h: int):
    return [(f"{prefix}.scale", (h,), 1.0, SMALL),
            (f"{prefix}.bias", (h,), 0.0, SMALL),
            (f"{prefix}.mean", (h,), 0.0, SMALL),
            (f"{prefix}.var", (h,), 1.0, SMALL)]


def _lstm_leaves(prefix: str, i: int, h: int):
    return [(f"{prefix}.kernel", (i, 4 * h), 0.0, _xavier_std(i, 4 * h)),
            (f"{prefix}.recurrent_kernel", (h, 4 * h), 0.0, _xavier_std(h, 4 * h)),
            (f"{prefix}.bias", (4 * h,), "forget", SMALL)]


def _gru_leaves(prefix: str, i: int, h: int):
    return [(f"{prefix}.kernel", (i, 3 * h), 0.0, _xavier_std(i, 3 * h)),
            (f"{prefix}.recurrent_kernel", (h, 3 * h), 0.0, _xavier_std(h, 3 * h)),
            (f"{prefix}.bias", (3 * h,), 0.0, SMALL),
            (f"{prefix}.recurrent_bias", (3 * h,), 0.0, SMALL)]


def plan(conf: dict) -> list[tuple]:
    """[(name, shape, mean, std)] of the transducer ("model.*") and, when
    the configuration has one, its LM ("lm.*"). mean "forget": an LSTM
    bias, 0 but 1 on the forget gate (gate order i, g, f, o)."""
    m = conf["model"]
    f, e, v = m["feature_sz"], m["embed_sz"], m["vocab_sz"]
    h, o, j = m["hidden_sz"], m["out_sz"], m["joint_sz"]
    if m["encoder"]["rnn_type"] != "LSTM" or m["predictor"]["rnn_type"] != "NBRC":
        raise ValueError("the plan covers an LSTM encoder and an NBRC predictor")
    if h != o or m["joint"]["method"] != "concat":
        raise ValueError("the plan covers hidden_sz == out_sz and the concat joint")
    out = [("model.encoder.input_norm.scale", (f,), 1.0, SMALL),
           ("model.encoder.input_norm.bias", (f,), 0.0, SMALL)]
    for i in range(m["encoder"]["num_layers"]):
        p = f"model.encoder.rnn_stack.layer{i}"
        out += _lstm_leaves(p + ".cell", f if i == 0 else h, h)
        out.append((p + ".h0", (2, 1, h), 0.0, SMALL))
        out += _norm_leaves(f"model.encoder.rnn_stack.norm{i}", h)
    out.append(("model.predictor.embed.embedding", (v, e), 0.0, 1 / math.sqrt(e)))
    if e != h:
        out += [("model.predictor.ffn.kernel", (e, h), 0.0, 1 / math.sqrt(e)),
                ("model.predictor.ffn.bias", (h,), 0.0, SMALL)]
    for i in range(m["predictor"]["num_layers"]):
        p = f"model.predictor.rnn_stack.layer{i}"
        out += _gru_leaves(p + ".cell", h, h)
        out.append((p + ".h0", (1, 1, h), 0.0, SMALL))
        out += _norm_leaves(f"model.predictor.rnn_stack.norm{i}", h)
    out += [("model.joint.pred_proj.kernel", (o, j), 0.0, 1 / math.sqrt(o)),
            ("model.joint.pred_proj.bias", (j,), 0.0, SMALL),
            ("model.joint.enc_proj.kernel", (o, j), 0.0, 1 / math.sqrt(o)),
            ("model.joint.out.kernel", (j, v), 0.0, 1 / math.sqrt(j)),
            ("model.joint.out.bias", (v,), 0.0, SMALL)]
    lm = conf.get("lm") or {}
    if lm.get("enable"):
        le, lh = lm["embed_sz"], lm["hidden_sz"]
        out.append(("lm.embed.embedding", (lm["vocab_sz"], le), 0.0,
                    1 / math.sqrt(le)))
        for i in range(lm["num_layers"]):
            out += _lstm_leaves(f"lm.lstm{i}", le if i == 0 else lh, lh)
        if le != lh:
            out += [("lm.out.kernel", (lh, lm["vocab_sz"]), 0.0, 1 / math.sqrt(lh)),
                    ("lm.out.bias", (lm["vocab_sz"],), 0.0, SMALL)]
    return out


def draw(leaf_plan: list[tuple], seed: int, device, blank_bias: float,
         gain: dict | None = None) -> dict:
    """Every leaf of `leaf_plan` from one normal draw of a generator on
    `device` seeded with `seed`; a leaf named in `gain` has its standard
    deviation multiplied by it; the joint's blank logit gets the
    configuration's pinned bias. Returns {name: float32 tensor}."""
    gain = gain or {}
    device = torch.device(device)
    total = sum(math.prod(s) for _, s, _, _ in leaf_plan)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    flat = torch.randn(total, generator=gen, device=device)
    leaves, off = {}, 0
    for name, shape, mean, std in leaf_plan:
        n = math.prod(shape)
        x = flat[off:off + n].view(shape) * (std * gain.get(name, 1.0))
        off += n
        if mean == "forget":
            hh = shape[0] // 4
            x[2 * hh:3 * hh] += 1.0
        else:
            x += mean
        leaves[name] = x
    leaves["model.joint.out.bias"][0] = blank_bias
    return leaves


def load_into(module: torch.nn.Module, leaves: dict, prefix: str) -> None:
    """Copy the leaves named `prefix.*` into `module`'s parameters and
    buffers of the same names, in place (a captured CUDA graph keeps
    reading the same storage). Every float leaf of the module must be in
    the plan, and every planned leaf in the module."""
    own = dict(module.named_parameters())
    own.update((k, b) for k, b in module.named_buffers()
               if b is not None and b.is_floating_point())
    want = {k[len(prefix) + 1:]: v for k, v in leaves.items()
            if k.startswith(prefix + ".")}
    if set(own) != set(want):
        raise ValueError(
            f"the {prefix} leaves differ from the plan: module only "
            f"{sorted(set(own) - set(want))}, plan only "
            f"{sorted(set(want) - set(own))}")
    with torch.no_grad():
        for k, t in own.items():
            t.copy_(want[k].reshape(t.shape))
