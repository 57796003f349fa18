"""The model's weights, made from the seed on the device.

The configuration's family (`benchmark/families/<model.name>.py`) lists
every leaf of the configured model by the name the program gives it
(its parameter and buffer names), with the distribution it is drawn
from, built from the leaf helpers here. `draw` makes all of them from
ONE normal draw on the device, so that set-up makes 70 million weights
in one call.
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


def xavier_std(fan_in: int, fan_out: int) -> float:
    return math.sqrt(2.0 / (fan_in + fan_out))


def norm_leaves(prefix: str, h: int):
    return [(f"{prefix}.scale", (h,), 1.0, SMALL),
            (f"{prefix}.bias", (h,), 0.0, SMALL),
            (f"{prefix}.mean", (h,), 0.0, SMALL),
            (f"{prefix}.var", (h,), 1.0, SMALL)]


def lstm_leaves(prefix: str, i: int, h: int):
    return [(f"{prefix}.kernel", (i, 4 * h), 0.0, xavier_std(i, 4 * h)),
            (f"{prefix}.recurrent_kernel", (h, 4 * h), 0.0, xavier_std(h, 4 * h)),
            (f"{prefix}.bias", (4 * h,), "forget", SMALL)]


def gru_leaves(prefix: str, i: int, h: int):
    return [(f"{prefix}.kernel", (i, 3 * h), 0.0, xavier_std(i, 3 * h)),
            (f"{prefix}.recurrent_kernel", (h, 3 * h), 0.0, xavier_std(h, 3 * h)),
            (f"{prefix}.bias", (3 * h,), 0.0, SMALL),
            (f"{prefix}.recurrent_bias", (3 * h,), 0.0, SMALL)]


def draw(leaf_plan: list[tuple], seed: int, device, blank_leaf: tuple,
         blank_bias: float, gain: dict | None = None) -> dict:
    """Every leaf of `leaf_plan` from one normal draw of a generator on
    `device` seeded with `seed`; a leaf named in `gain` has its standard
    deviation multiplied by it; the element `blank_leaf` = (name, index),
    the blank logit's bias, gets the configuration's pinned bias.
    Returns {name: float32 tensor}. mean "forget": an LSTM bias, 0 but 1
    on the forget gate (gate order i, g, f, o)."""
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
    name, index = blank_leaf
    leaves[name][index] = blank_bias
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
