"""Data parallelism of the port on the CPU: two gloo ranks (data 2)
against the port's single process on the global batch, and against the
JAX package's two-process step (tests/test_distributed.py).

Each group of ranks runs tests/helpers/torch_dist_worker.py with its own
file:// store and time limit.

Tolerances:
- 2 ranks against 1 process, with the frontend, SpecAugment, dropout,
  batch norms, the tmp-state carry and accumulation 2 on: losses 1e-5
  relative; parameters and batch statistics after three SGD steps 3e-4
  relative and 1e-5 absolute, the bounds tests/test_pp_train.py:86-93
  sets JAX for a change of schedule (here the batch norms' and the
  loss's sums are split over two ranks and added back);
- against JAX's run_steps_with_checkpoint: losses 1e-5 relative, as
  tests/test_torch_train.py holds the port's step to JAX's.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

from helpers.noise_corpus import tiny_conf
from helpers.torch_dist import run_ranks
from libreasr_tpu_torch.training.checkpoint import (restore_train_state,
                                                    save_train_state)
from libreasr_tpu_torch.training.learner import Batch, Learner


def dp_conf():
    conf = tiny_conf("unused", "unused")
    conf["model"]["encoder"].update(dropout=0.1, use_tmp_state_pcent=0.5)
    conf["model"]["predictor"]["dropout"] = 0.1
    conf["transforms"]["features"].insert(
        1, {"name": "MaskTime", "args": {"num_masks": 2, "size": 2}})
    conf["accumulate_n_batches"] = 2
    conf["training"].update(optimizer="sgd", lr=1e-2, warmup_pct=0.1)
    return conf


def global_batches(k, seed=0, n=4, s=16000, u=6, v=40):
    rng = np.random.default_rng(seed)
    out = {f: [] for f in Batch._fields}
    for _ in range(k):
        out["audio"].append((rng.standard_normal((n, s)) * 0.1).astype(np.float32))
        out["audio_len"].append(np.array([s, s - 2000, s - 5000, s - 9000]))
        out["labels"].append(rng.integers(1, v, (n, u)).astype(np.int32))
        out["label_len"].append(np.array([u, u - 1, 3, 2]))
    return {f: np.stack(x) for f, x in out.items()}


def _batch(batches, k):
    return Batch(*(torch.from_numpy(batches[f][k]) for f in Batch._fields))


def test_two_rank_step_equals_single_process_and_checkpoints_move(tmp_path):
    """3 steps on data 2 against the single process; the single process's
    checkpoint restores on data 2, and data 2's in one process: the next
    step's loss is the uninterrupted single process's."""
    conf = dp_conf()
    batches = global_batches(4)
    np.savez(tmp_path / "b.npz", **batches)
    ref = Learner.from_config(copy.deepcopy(conf), device="cpu")
    losses = [float(ref.step(_batch(batches, k))["loss"]) for k in range(3)]
    want = {k: v.clone() for k, v in ref.model.state_dict().items()}
    save_train_state(str(tmp_path / "ck_sp"), ref)
    loss4 = float(ref.step(_batch(batches, 3))["loss"])

    res, out = run_ranks(tmp_path, {
        "scenario": "train", "mesh": {"data": 2}, "conf": conf,
        "batches": str(tmp_path / "b.npz"), "steps": 3,
        "save": str(tmp_path / "ck_dp"),
        "then_restore": str(tmp_path / "ck_sp")}, world=2)
    for r in res:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(r["resumed"][0], loss4, rtol=1e-5)
    got = torch.load(out / "params.pt")
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=3e-4, atol=1e-5, err_msg=name)

    one = Learner.from_config(copy.deepcopy(conf), device="cpu", seed=7)
    assert restore_train_state(str(tmp_path / "ck_dp"), one) == 3
    for name, t in one.model.state_dict().items():
        assert torch.equal(t, got[name]), name
    assert sorted(one.carries) == [4]
    np.testing.assert_allclose(float(one.step(_batch(batches, 3))["loss"]),
                               loss4, rtol=1e-5)


def test_two_rank_checkpointed_steps_match_jax(tmp_path):
    """JAX's run_steps_with_checkpoint (one step, save, a fresh learner,
    restore, the same batch again) on a JAX mesh of data 2, and the port's
    on two ranks from the same weights: equal losses, equal on every
    rank."""
    import jax
    from flax import serialization

    from libreasr_tpu.models.transducer import TransducerConfig as JaxConfig
    from libreasr_tpu.models.transducer import init_transducer
    from libreasr_tpu.parallel import distributed as jdist
    from libreasr_tpu.parallel.mesh import make_mesh as jax_make_mesh

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
    from dist_worker import make_global_inputs, run_steps_with_checkpoint

    kw = dict(feature_sz=64, embed_sz=8, vocab_sz=40, hidden_sz=16, out_sz=16,
              joint_sz=16, enc_num_layers=1, pred_num_layers=1,
              enc_dropout=0.0, pred_dropout=0.0)
    _, jvars = init_transducer(JaxConfig(**kw), jax.random.PRNGKey(0))
    torch.save(serialization.to_state_dict(
        jax.tree_util.tree_map(np.asarray, jvars)), tmp_path / "w.pt")
    feats, labels, xl, yl = make_global_inputs()
    np.savez(tmp_path / "b.npz", audio=feats[None], audio_len=xl[None],
             labels=labels[None], label_len=yl[None])
    res, _ = run_ranks(tmp_path, {
        "scenario": "train", "mesh": {"data": 2}, "cfg": kw,
        "weights": str(tmp_path / "w.pt"), "opt": {"name": "adam", "lr": 1e-3},
        "batches": str(tmp_path / "b.npz"), "steps": 1,
        "resume": str(tmp_path / "ck"), "restore_like_jax": True}, world=2)

    want = run_steps_with_checkpoint(jax_make_mesh(data=2, model=1), jdist,
                                     str(tmp_path / "jax_ckpt"))
    for r in res:
        np.testing.assert_allclose([r["losses"][0], r["resumed"][0]], want,
                                   rtol=1e-5)


def test_initialize_reads_torchrun_environment(monkeypatch, capsys):
    """Under torchrun (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT set)
    initialize() starts env://; with neither flags nor that environment
    it is the single process and says so, as JAX's does."""
    import socket

    import torch.distributed as tdist

    from libreasr_tpu_torch.parallel import distributed as dist

    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    dist.initialize(device="cpu")
    assert "[distributed] single-process mode" in capsys.readouterr().out
    assert not tdist.is_initialized()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    dist.initialize(device="cpu", timeout_s=60)
    try:
        assert tdist.is_initialized() and tdist.get_backend() == "gloo"
        assert (dist.process_count(), dist.process_index()) == (1, 0)
        # a mesh over the one process: no axis of more than one rank,
        # so no group to exchange over
        mesh = dist.global_mesh()
        assert mesh.shape == {"data": 1, "model": 1} and not mesh.groups
    finally:
        tdist.destroy_process_group()


@pytest.mark.parametrize("fault", ["missing_batch_stat", "wrong_shape",
                                   "unexpected_key"])
def test_restore_refuses_a_checkpoint_of_another_model(tmp_path, fault):
    """restore_train_state is strict, as torch's load_state_dict: a
    checkpoint without a batch norm's running mean, with a tensor of
    another shape, or with a key the model lacks raises and names it."""
    conf = dp_conf()
    learner = Learner.from_config(copy.deepcopy(conf), device="cpu")
    path = tmp_path / "ck"
    save_train_state(str(path), learner)
    payload = torch.load(path / "train_state.pt", weights_only=True)
    sd = payload["model"]
    stat = next(n for n in sd if n.endswith(".mean"))
    if fault == "missing_batch_stat":
        del sd[stat]
    elif fault == "wrong_shape":
        sd[stat] = torch.zeros(sd[stat].shape[0] + 1)
    else:
        sd["encoder.extra.weight"] = torch.zeros(2)
    torch.save(payload, path / "train_state.pt")
    fresh = Learner.from_config(copy.deepcopy(conf), device="cpu", seed=3)
    name = "encoder.extra.weight" if fault == "unexpected_key" else stat
    with pytest.raises(RuntimeError, match=name.replace(".", r"\.")):
        restore_train_state(str(path), fresh)
