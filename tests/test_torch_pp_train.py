"""Pipeline-parallel training of the port (Learner on a pipe axis, train
--pp) against the JAX package's plain step (tests/test_pp_train.py:68-134):
gloo ranks on data 2 x pipe 2 from JAX's weights on test_pp_train's
`_cfg`, the leftover sequential layers, _validate_pp's refusals and the
CLI's --pp flag on four ranks.

Tolerances are JAX's own for its pipeline against its plain step
(tests/test_pp_train.py:86-93): losses 2e-4 relative; parameters after
three SGD steps 3e-4 relative and 1e-5 absolute. The leftover layers are
held to the port's single process, which tests/test_torch_train.py
holds to JAX's step.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from helpers.noise_corpus import make_noise_corpus, tiny_conf
from helpers.torch_dist import ROOT, run_ranks
from libreasr_tpu_torch.convert import flatten_variables, load_jax_variables
from libreasr_tpu_torch.models.transducer import Transducer, TransducerConfig
from libreasr_tpu_torch.parallel.mesh import make_mesh
from libreasr_tpu_torch.training import optimizers as topt
from libreasr_tpu_torch.training.learner import Batch, Learner, LossConfig
from test_pp_train import _batch, _cfg
from test_pp_train import _learner as jax_learner

# _cfg's fields in the port's names
PORT_CFG = dict(feature_sz=16, embed_sz=8, vocab_sz=24, hidden_sz=16, out_sz=16,
                joint_sz=16, enc_num_layers=3, pred_num_layers=1,
                enc_dropout=0.0, pred_dropout=0.0, enc_norm="none",
                pred_norm="none", enc_use_kernel=False,
                enc_use_train_kernel=False, use_tmp_state_pcent=0.0)


def _run_pp(tmp_path, n_layers, mesh, k, jax_ref=True):
    """k steps on `mesh` from JAX's weights; the reference losses are
    JAX's plain step's, or with jax_ref False the port's single process's
    (itself held to JAX's by tests/test_torch_train.py)."""
    cfg = _cfg(enc_num_layers=n_layers)
    rng = np.random.default_rng(0 if n_layers == 3 else 1)
    batches = [_batch(rng) for _ in range(k)]
    ref = jax_learner(cfg, mesh=None)
    weights = serialization.to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": ref.state.params}))
    torch.save(weights, tmp_path / "w.pt")
    np.savez(tmp_path / "b.npz", **{f: np.stack([np.asarray(getattr(b, f))
                                                 for b in batches])
                                    for f in batches[0]._fields})
    port_cfg = {**PORT_CFG, "enc_num_layers": n_layers}
    res, out = run_ranks(tmp_path, {
        "scenario": "train", "mesh": mesh, "cfg": port_cfg,
        "weights": str(tmp_path / "w.pt"), "opt": {"name": "sgd", "lr": 1e-2},
        "loss": {"fused": True}, "pp_micro": 2,
        "batches": str(tmp_path / "b.npz"), "steps": k},
        world=mesh["data"] * mesh["pipe"])
    if jax_ref:
        losses = [float(ref.step(b)["loss"]) for b in batches]
    else:
        model = Transducer(TransducerConfig(**port_cfg))
        load_jax_variables(model, weights)
        plain = Learner(model, topt.build_optimizer("sgd", 1e-2), None,
                        LossConfig(fused=True))
        losses = [float(plain.step(Batch(*(torch.from_numpy(np.asarray(x))
                                          for x in b)))["loss"])
                  for b in batches]
    return ref, res, out, losses


def test_pp_step_matches_jax_plain_step(tmp_path):
    """2 stages on data 2 x pipe 2 against JAX's single-device step: the
    loss of every step and the parameters after 3 steps."""
    ref, res, out, losses = _run_pp(tmp_path, 3, {"data": 2, "pipe": 2}, 3)
    for r in res:
        np.testing.assert_allclose(r["losses"], losses, rtol=2e-4)
    want = flatten_variables(serialization.to_state_dict(
        jax.tree_util.tree_map(np.asarray, ref.state.params)))
    got = torch.load(out / "params.pt")
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=3e-4,
                                   atol=1e-5, err_msg=f"param diverged: {name}")


def test_pp_handles_leftover_sequential_layers(tmp_path):
    """6 layers over 2 stages: 2 sequential (the input layer included),
    4 pipelined; against the port's single process."""
    _, res, _, losses = _run_pp(tmp_path, 6, {"data": 1, "pipe": 2}, 1,
                                jax_ref=False)
    for r in res:
        np.testing.assert_allclose(r["losses"], losses, rtol=2e-4)


def test_pp_validation_rejects_bad_configs():
    mesh = make_mesh(data=2, model=1, pipe=2, devices=["cpu"] * 4)
    tx = topt.build_optimizer("adam", 1e-3)

    def learner(loss, **kw):
        model = Transducer(TransducerConfig(**{**PORT_CFG, **kw}))
        return Learner(model, tx, None, LossConfig(fused=loss), mesh=mesh)

    with pytest.raises(ValueError, match="fused"):
        learner(False)
    with pytest.raises(ValueError, match="norm"):
        learner(True, enc_norm="batch")
    with pytest.raises(ValueError, match="use_tmp_state_pcent"):
        learner(True, use_tmp_state_pcent=0.5)
    with pytest.raises(ValueError, match="divisible|fill"):
        learner(True, enc_num_layers=2)


def test_train_cli_pp_flag(tmp_path):
    """`--pp 2 --pp-micro 2` on four CLI processes (data 2 x pipe 2) over a
    noise corpus through the whole data pipeline: the pipe mesh engages,
    two steps run, the run ends with its checkpoint and the multi-host
    line."""
    root = tmp_path / "corpus"
    root.mkdir()
    conf = tiny_conf(make_noise_corpus(root), str(root / "no-tokenizer"))
    conf["model"]["encoder"]["num_layers"] = 3
    path = tmp_path / "conf.yaml"
    path.write_text(yaml.safe_dump(conf))
    env = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    cmd = [sys.executable, "-m", "libreasr_tpu_torch.train", "--config", str(path),
           "--device", "cpu", "--steps", "2", "--pp", "2", "--pp-micro", "2",
           "--ckpt", str(tmp_path / "ck"), "--logdir", str(tmp_path / "runs"),
           "--dist-coordinator", f"file://{tmp_path / 'store'}",
           "--dist-procs", "4"]
    procs = [subprocess.Popen(cmd + ["--dist-pid", str(r)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(4)]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    assert "[train] pipeline parallelism: 2 stages x 2 microbatches" in outs[0]
    assert "[train] mesh: {'data': 2, 'model': 1, 'pipe': 2}" in outs[0]
    assert "[train] done (multi-host): step=2 loss=" in outs[0]
    assert all("[train] done" not in o for o in outs[1:])
    state = torch.load(tmp_path / "ck" / "train_state.pt", weights_only=True)
    assert state["step"] == 2
    n = Transducer(TransducerConfig.from_config({**conf, "model": {
        **conf["model"], "encoder": {**conf["model"]["encoder"], "norm": "none"}}}))
    assert set(state["model"]) == set(n.state_dict())
