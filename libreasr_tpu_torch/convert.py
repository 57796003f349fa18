"""JAX variables -> the port's modules.

The port names its submodules and parameters after the flax modules,
so the flax path `params/encoder/rnn_stack/layer0/cell/kernel` is the
torch parameter `encoder.rnn_stack.layer0.cell.kernel`, and
`batch_stats/.../norm0/mean` the buffer `....norm0.mean`. Layouts are
the same on both sides; nothing is transposed.
"""

from __future__ import annotations

import numpy as np
import torch


def flatten_variables(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict -> {"a.b.c": leaf}."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_variables(v, name))
        else:
            out[name] = np.asarray(v)
    return out


@torch.no_grad()
def load_jax_variables(model: torch.nn.Module, variables: dict) -> None:
    """Copy a JAX variables dict ({"params": ..., "batch_stats": ...} of
    numpy arrays, as checkpoint.load_bundle returns it) into `model`.
    Every tensor of the model must be filled, and every leaf used, with
    matching shapes."""
    leaves = {}
    for collection in ("params", "batch_stats"):
        leaves.update(flatten_variables(variables.get(collection, {})))
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    missing = sorted(set(targets) - set(leaves))
    unused = sorted(set(leaves) - set(targets))
    if missing or unused:
        raise ValueError(
            f"variables do not match the model: missing {missing}, "
            f"unused {unused}"
        )
    for name, t in targets.items():
        src = leaves[name]
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {src.shape} != {tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.array(src, np.float32)))
