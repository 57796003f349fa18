"""A run with the timed path broken underneath comes out not correct:
the harness's look for a chip is skipped, everything after it runs, at
a tiny size on the CPU, with the cells' own limits. Faults a stream
cell can have: a token altered where the step produces it, and a step
that returns its state unchanged."""

import dataclasses

import pytest
import torch

from benchmark import core
from benchmark.run import check
from benchmark.tests.tiny import tiny_bench

# At this size bf16's rounding alone flips decisions the cells' limits
# were not set for, so the towers run in float32 here (the program then
# matches the reference exactly); the seed is one whose tiny model emits.
CELLS = {"stream-greedy-backlog": dict(bias=17.0, gain=16.0, compute="float32"),
         "stream-beam4lm-backlog": dict(bias=14.0, gain=16.0, compute="float32")}
SEED = 32


def _altered_token(step_fn):
    def step(self, state, chunks, valid, reset):
        new, packed = step_fn(self, state, chunks, valid, reset)
        toks = packed[:, :1]
        bumped = torch.where(toks > 3, (toks + 1) % self.cfg.vocab_sz, toks)
        return new, torch.cat([bumped, packed[:, 1:]], dim=1)
    return step


def _state_unchanged(step_fn):
    def step(self, state, chunks, valid, reset):
        new, packed = step_fn(self, state, chunks, valid, reset)
        keep = dataclasses.replace(new, enc_state=state.enc_state,
                                   decode=state.decode)
        return keep, packed
    return step


def _run(cell, fault, monkeypatch):
    from libreasr_tpu_torch.models import streaming

    if fault is not None:
        monkeypatch.setattr(streaming.StreamingEngine, "step_fn",
                            fault(streaming.StreamingEngine.step_fn))
    drv = tiny_bench(cell, SEED, **CELLS[cell]).generator()
    drv.setup()
    drv.window(2.0)
    drv.release()
    return check(drv, core.load_json("workloads", cell)["limits"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell, monkeypatch):
    ok, rows, faults, _ = _run(cell, None, monkeypatch)
    assert ok, (rows, faults)


@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged],
                         ids=["altered_token", "state_unchanged"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    ok, rows, faults, _ = _run(cell, fault, monkeypatch)
    assert not ok, rows
