"""JAX variables <-> the port's modules.

The port names its submodules and parameters after the flax modules,
so the flax path `params/encoder/rnn_stack/layer0/cell/kernel` is the
torch parameter `encoder.rnn_stack.layer0.cell.kernel`, and
`batch_stats/.../norm0/mean` the buffer `....norm0.mean`. An int8 cell
matrix is stored as `.../cell/kernel/q` (int8) and `.../scale`
(float32), the torch buffers `...cell.kernel.q` and `...cell.kernel.scale`.
Layouts are the same on both sides; nothing is transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.modules import MaskedBatchNorm, QuantizedWeight

# the JAX package keeps the batch-norm running statistics in their own
# collection; every other leaf is a parameter
_COLLECTIONS = ("params", "batch_stats")


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
    Every saved tensor of the model must be filled, and every leaf used,
    with matching shapes. int8 leaves fill int8 tensors and nothing
    else; every other leaf is copied as float32. Quantized cells then
    remake their kernel layouts."""
    leaves = {}
    for collection in _COLLECTIONS:
        leaves.update(flatten_variables(variables.get(collection, {})))
    targets = model.state_dict(keep_vars=True)
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
        if (src.dtype == np.int8) != (t.dtype == torch.int8):
            raise TypeError(f"{name}: leaf is {src.dtype}, tensor {t.dtype}")
        t.copy_(torch.from_numpy(np.array(src, np.int8 if t.dtype == torch.int8
                                          else np.float32)))
    for m in model.modules():
        if isinstance(m, QuantizedWeight):
            m.repack()


@torch.no_grad()
def export_variables(model: torch.nn.Module) -> dict:
    """The inverse of load_jax_variables: the model's saved tensors as a
    nested {"params": ..., "batch_stats": ...} dict of numpy arrays in
    the JAX layout (float32, int8 for quantized matrices)."""
    stats = {f"{name}.{b}" for name, m in model.named_modules()
             if isinstance(m, MaskedBatchNorm) for b in ("mean", "var")}
    out = {c: {} for c in _COLLECTIONS}
    for name, t in model.state_dict().items():
        node = out["batch_stats" if name in stats else "params"]
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().cpu().numpy().copy()
    return {c: tree for c, tree in out.items() if tree}


def load_jax_lm_variables(lm: torch.nn.Module, variables: dict) -> None:
    """Copy a JAX LM's variables into the port's models.lm.LM: the flax
    tree {"params": {"embed": {"embedding"}, "lstm{i}": {"kernel",
    "recurrent_kernel", "bias"}, "out": {"kernel", "bias"}}} of numpy
    arrays, as checkpoint.msgpack_restore reads a bundle's lm.msgpack
    ("out" only when the LM is untied). The names are the port's, so
    this is load_jax_variables with the same checks: every tensor
    filled, every leaf used, shapes equal."""
    if set(variables) - {"params"}:
        raise ValueError(f"an LM has params only, got {sorted(variables)}")
    load_jax_variables(lm, variables)


def export_lm_variables(lm: torch.nn.Module) -> dict:
    """The inverse of load_jax_lm_variables: {"params": ...} of numpy
    arrays, the tree the JAX package serializes into lm.msgpack."""
    return export_variables(lm)


def load_jax_ctc_variables(model: torch.nn.Module, variables: dict) -> None:
    """Copy a JAX CTCModel's variables (init_ctc's tree {"params":
    {"in_proj"?, "block{i}": {"LayerNorm_0", "MultiHeadDotProductAttention_0":
    {"query", "key", "value", "out"}, "LayerNorm_1", "Dense_0", "Dense_1"},
    "LayerNorm_0", "out"}} of numpy arrays) into the port's
    models.ctc.CTCModel, whose names are flax's: load_jax_variables with
    its checks."""
    if set(variables) - {"params"}:
        raise ValueError(f"a CTC model has params only, got {sorted(variables)}")
    load_jax_variables(model, variables)


def export_ctc_variables(model: torch.nn.Module) -> dict:
    """The inverse of load_jax_ctc_variables: {"params": ...} of numpy
    arrays in flax's layout."""
    return export_variables(model)
