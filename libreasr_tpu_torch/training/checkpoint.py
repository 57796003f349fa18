"""Training checkpoints in the port's own format.

A checkpoint is a directory holding one `train_state.pt` (torch.save of
plain containers of tensors, loaded with weights_only): the model's
parameters and batch statistics, the optimizer state, the step, the
per-batch-size carries and the states of the Learner's two generators,
so that a resumed run draws what the uninterrupted one would have.
Release bundles stay the JAX package's layout
(libreasr_tpu_torch.checkpoint.save_bundle).

Under a mesh every rank calls both functions. Rank 0 writes one file
holding whole tensors, whole optimizer state and the global carries
(every data slot's rows), the file a single process writes, so it does
not depend on the mesh that wrote it; a restore keeps each rank's rows,
column blocks or stage, on any mesh or none.
"""

from __future__ import annotations

import os

import torch

from .learner import BatchCarry, TrainState

STATE_FILE = "train_state.pt"


def _per_param(tree, n: int, fn):
    """Apply fn to every list of n tensors in an optimizer state (its
    per-parameter lists: moments, slow weights, accumulators)."""
    if isinstance(tree, list) and len(tree) == n and n and all(
            isinstance(t, torch.Tensor) for t in tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _per_param(v, n, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_per_param(v, n, fn) for v in tree)
    return tree


def _tensors(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tuple(_tensors(t, fn) for t in tree)


@torch.no_grad()
def _global_carries(learner) -> dict:
    data = learner._data()
    out = {}
    for n in sorted(learner.carries):
        c = learner.carries[n]
        if data is None:
            out[n] = c._asdict()
            continue
        from ..parallel.collectives import GatherRows

        gather = lambda t: GatherRows.apply(t.contiguous(), *data)
        out[n * data[1]] = BatchCarry(_tensors(c.enc_state, gather),
                                      _tensors(c.pred_state, gather),
                                      gather(c.bos), c.valid)._asdict()
    return out


def _local_carries(learner, carries: dict) -> dict:
    data = learner._data()
    d, i = (1, 0) if data is None else data[1:]
    out = {}
    for n, c in carries.items():
        n = int(n)
        if n % d:
            continue  # no batch of this size can be split over the data axis
        rows = lambda t, k=n // d: t[i * k:(i + 1) * k].clone()
        out[n // d] = BatchCarry(_tensors(c["enc_state"], rows),
                                 _tensors(c["pred_state"], rows),
                                 rows(c["bos"]), c["valid"])
    return out


def save_train_state(path: str, learner) -> str:
    """Write `learner`'s state into the directory `path` (atomically:
    a crash mid-write leaves the previous checkpoint). Collective under
    a mesh: rank 0 writes, every rank returns once the file exists."""
    payload = {
        "step": int(learner.state.step),
        "model": learner.state_dict(),
        "opt_state": _per_param(learner.state.opt_state, len(learner.params),
                                learner.to_global),
        "carries": _global_carries(learner),
        "host_gen": learner.host_gen.get_state(),
        "gen": learner.gen.get_state(),
    }
    out = os.path.join(path, STATE_FILE)
    rank0 = learner.mesh is None or learner.mesh.index_global() == 0
    if rank0:
        os.makedirs(path, exist_ok=True)
        torch.save(payload, out + ".tmp")
        os.replace(out + ".tmp", out)
    if learner.mesh is not None and learner.mesh.groups:
        import torch.distributed as dist

        dist.barrier()
    return out


def _load(path: str, device):
    return torch.load(os.path.join(path, STATE_FILE), map_location=device,
                      weights_only=True)


def restore_train_state(path: str, learner) -> int:
    """Load a checkpoint written by save_train_state into `learner` (same
    model and optimizer configuration). Returns the step."""
    payload = _load(path, learner.device)
    learner.load_state_dict(payload["model"])
    opt_state = _per_param(payload["opt_state"], len(learner.names),
                           learner.to_local)
    learner.state = TrainState(step=payload["step"], opt_state=opt_state)
    learner.carries = _local_carries(learner, payload["carries"])
    learner.host_gen.set_state(payload["host_gen"].cpu())
    learner.gen.set_state(payload["gen"].cpu())
    return learner.state.step


def restore_params_only(path: str, model) -> int:
    """Load only the model's parameters and batch statistics (for a
    bundle export, whatever optimizer wrote the checkpoint). Returns the
    step."""
    payload = _load(path, next(model.parameters()).device)
    model.load_state_dict(payload["model"])
    return payload["step"]
