"""The model axis of the port on the CPU: gloo ranks on data 1 x model 2
and data 2 x model 2 against the single process on the global batch,
with ranger (base.yaml's optimizer) and lamb (a per-tensor norm, its
trust ratio summed over the model group).

The sharded leaves (mesh.leaf_spec, the leaves JAX's param_shardings
shards: tests/test_torch_mesh.py) and their optimizer moments take half
the bytes on each rank that they take in one process. This stands in
for tests/test_aot_multichip.py's memory check, which reads XLA's
compiled memory and has no counterpart in the port.

Tolerances: losses 1e-5 relative; parameters and batch statistics after
three steps 3e-4 relative and 1e-5 absolute, as tests/test_pp_train.py
holds JAX's change of schedule (the norms' and the loss's sums are
taken in parts and added).
"""

import copy

import numpy as np
import pytest
import torch

from helpers.noise_corpus import tiny_conf
from helpers.torch_dist import run_ranks
from libreasr_tpu_torch.parallel.mesh import make_mesh, param_shardings
from libreasr_tpu_torch.training.checkpoint import _per_param
from libreasr_tpu_torch.training.learner import Learner
from test_torch_distributed import _batch, global_batches


def axis_conf(optimizer):
    conf = tiny_conf("unused", "unused")
    conf["model"]["hidden_sz"] = 16
    conf["model"]["out_sz"] = 16
    conf["model"]["joint_sz"] = 16
    conf["model"]["encoder"]["use_tmp_state_pcent"] = 0.5
    conf["training"].update(optimizer=optimizer, lr=1e-2, wd=0.01)
    return conf


OPTIMIZERS = ("ranger", "lamb")


@pytest.mark.parametrize("data", [1, 2], ids=["d1m2", "d2m2"])
def test_model_axis_step_equals_single_process(tmp_path, data):
    """One group of ranks trains with each optimizer in turn."""
    batches = global_batches(3, seed=1)
    np.savez(tmp_path / "b.npz", **batches)
    res, out = run_ranks(tmp_path, {
        "scenario": "train", "mesh": {"data": data, "model": 2},
        "variants": [{"conf": axis_conf(o)} for o in OPTIMIZERS],
        "batches": str(tmp_path / "b.npz"), "steps": 3}, world=2 * data)
    for i, optimizer in enumerate(OPTIMIZERS):
        _check(axis_conf(optimizer), batches, [r[i] for r in res],
               out / f"params{i}.pt")


def _check(conf, batches, res, params_file):
    ref = Learner.from_config(copy.deepcopy(conf), device="cpu")
    for k in range(3):
        loss = float(ref.step(_batch(batches, k))["loss"])
        for r in res:
            np.testing.assert_allclose(r["losses"][k], loss, rtol=1e-5)
    got = torch.load(params_file)
    want = ref.model.state_dict()
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=3e-4, atol=1e-5, err_msg=name)

    # storage: the sharded leaves and their moments, halved on every rank
    rule = param_shardings(make_mesh(data=1, model=2, devices=["cpu"] * 2),
                           ref.model)
    sharded = [i for i, (n, _) in enumerate(ref.model.named_parameters())
               if rule[n] == "model"]
    assert sharded
    whole = sum(ref.params[i].numel() * 4 for i in sharded)
    lists = []
    _per_param(ref.state.opt_state, len(ref.params),
               lambda t: lists.append(t) or t)
    moments = sum(lst[i].numel() * lst[i].element_size()
                  for lst in lists for i in sharded)
    assert moments >= 2 * whole  # radam's or lamb's mu and nu, at least
    for r in res:
        assert 2 * r["sharded_bytes"] == whole
        assert 2 * r["moment_bytes"] == moments


def test_adahessian_on_a_model_axis_raises_its_named_error():
    conf = axis_conf("adahessian")
    conf["loss"]["fused"] = False
    conf["model"]["encoder"]["use_pallas_train"] = False
    mesh = make_mesh(data=1, model=2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="adahessian cannot run on a model axis"):
        Learner.from_config(conf, device="cpu", mesh=mesh)
