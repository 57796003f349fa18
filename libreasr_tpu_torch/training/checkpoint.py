"""Training checkpoints in the port's own format.

A checkpoint is a directory holding one `train_state.pt` (torch.save of
plain containers of tensors, loaded with weights_only): the model's
parameters and batch statistics, the optimizer state, the step, the
per-batch-size carries and the states of the Learner's two generators,
so that a resumed run draws what the uninterrupted one would have.
Release bundles stay the JAX package's layout
(libreasr_tpu_torch.checkpoint.save_bundle).
"""

from __future__ import annotations

import os

import torch

from .learner import BatchCarry, TrainState

STATE_FILE = "train_state.pt"


def save_train_state(path: str, learner) -> str:
    """Write `learner`'s state into the directory `path` (atomically:
    a crash mid-write leaves the previous checkpoint)."""
    os.makedirs(path, exist_ok=True)
    payload = {
        "step": int(learner.state.step),
        "model": learner.model.state_dict(),
        "opt_state": learner.state.opt_state,
        "carries": {n: c._asdict() for n, c in learner.carries.items()},
        "host_gen": learner.host_gen.get_state(),
        "gen": learner.gen.get_state(),
    }
    out = os.path.join(path, STATE_FILE)
    torch.save(payload, out + ".tmp")
    os.replace(out + ".tmp", out)
    return out


def _load(path: str, device):
    return torch.load(os.path.join(path, STATE_FILE), map_location=device,
                      weights_only=True)


def restore_train_state(path: str, learner) -> int:
    """Load a checkpoint written by save_train_state into `learner` (same
    model and optimizer configuration). Returns the step."""
    payload = _load(path, learner.device)
    learner.model.load_state_dict(payload["model"])
    learner.state = TrainState(step=payload["step"], opt_state=payload["opt_state"])
    learner.carries = {int(n): BatchCarry(**c) for n, c in payload["carries"].items()}
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
