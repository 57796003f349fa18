"""The port's mesh against the JAX package's (tests/test_utils_mesh.py:53-73):
the leaf rule marks sharded exactly the leaves JAX's param_shardings
shards, on the same model, at model 2 and 4; the data axis inference and
its errors; the rows of a data index."""

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from libreasr_tpu.models.transducer import TransducerConfig as JaxConfig
from libreasr_tpu.models.transducer import init_transducer
from libreasr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from libreasr_tpu.parallel.mesh import param_shardings as jax_param_shardings
from libreasr_tpu_torch.convert import flatten_variables, load_jax_variables
from libreasr_tpu_torch.models.transducer import Transducer, TransducerConfig
from libreasr_tpu_torch.parallel import distributed as dist
from libreasr_tpu_torch.parallel.mesh import (leaf_spec, make_mesh,
                                              param_shardings, shard_batch)

CPUS = ["cpu"] * 8


def test_mesh_shapes_and_leaf_rule():
    mesh = make_mesh(data=4, model=2, devices=CPUS)
    assert mesh.shape == {"data": 4, "model": 2}
    rule = param_shardings(mesh, {
        "wide": np.zeros((64, 128)),   # column-sharded on model
        "narrow": np.zeros((4, 3)),    # replicated (not divisible)
        "h0": np.zeros((2, 1, 16)),
        "bias": np.zeros(128),
    })
    assert rule == {"wide": "model", "narrow": None, "h0": None, "bias": None}
    assert leaf_spec("batch_stats.norm0.mean", (64, 128), 2) is None
    with pytest.raises(AssertionError, match="> 8 devices"):
        make_mesh(data=7, model=3, devices=CPUS)


def test_mesh_infers_the_data_axis_and_its_errors():
    assert make_mesh(data=-1, model=2, devices=CPUS).shape == {"data": 4, "model": 2}
    assert make_mesh(data=-1, model=2, pipe=2, devices=CPUS).shape == {
        "data": 2, "model": 2, "pipe": 2}
    with pytest.raises(AssertionError, match="not divisible"):
        make_mesh(data=-1, model=3, devices=CPUS)
    # over processes: the single process without a process group
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and not mesh.groups
    with pytest.raises(AssertionError, match="> 1 devices"):
        make_mesh(data=2)


def test_rows_of_a_data_index():
    mesh = make_mesh(data=1)
    assert dist.process_row_slice(mesh, 6) == slice(0, 6)
    mesh.shape["data"], mesh.coords["data"] = 3, 2  # as rank 2 of data 3
    assert dist.process_row_slice(mesh, 6) == slice(4, 6)
    x = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(shard_batch(mesh, (x, x[:, 0]))[0], x[4:])
    with pytest.raises(AssertionError, match="not divisible"):
        dist.local_batch_size(mesh, 7)


def test_replicate_tree_keeps_the_column_block():
    """Without a process group there is nothing to broadcast: each leaf
    stays, cut to this rank's column block where it is sharded."""
    mesh = make_mesh(data=1, model=2, devices=["cpu"] * 2)
    mesh.coords["model"] = 1  # as the second rank of the model axis
    w = torch.arange(64 * 16, dtype=torch.float32).reshape(64, 16)
    out = dist.replicate_tree(mesh, {"w": w, "b": w[0]})
    assert torch.equal(out["w"], w[:, 8:]) and torch.equal(out["b"], w[0])
    assert dist.all_processes_agree(3.5)


def test_leaf_rule_shards_what_jax_shards():
    """The same model in both packages (base.yaml's shapes cut to a few
    layers), at model 2 and 4: every leaf sharded on "model" by JAX is
    sharded by the port, and no other."""
    kw = dict(feature_sz=40, embed_sz=16, vocab_sz=64, hidden_sz=32, out_sz=24,
              joint_sz=32, enc_num_layers=2, pred_num_layers=1)
    _, jvars = init_transducer(JaxConfig(**kw), jax.random.PRNGKey(0))
    model = Transducer(TransducerConfig(**kw))
    flat = flatten_variables(serialization.to_state_dict(
        jax.tree_util.tree_map(np.asarray, jvars)))
    load_jax_variables(model, serialization.to_state_dict(
        jax.tree_util.tree_map(np.asarray, jvars)))
    for model_size in (2, 4):
        jmesh = jax_make_mesh(data=8 // model_size, model=model_size)
        specs = jax.tree_util.tree_map(lambda s: "model" in str(s.spec),
                                       jax_param_shardings(jmesh, jvars))
        want = {k: bool(v) for k, v in
                flatten_variables(serialization.to_state_dict(specs)).items()}
        mesh = make_mesh(data=-1, model=model_size, devices=CPUS)
        rule = param_shardings(mesh, model)
        got = {("batch_stats." if n.endswith((".mean", ".var")) else "params.")
               + n: s == "model" for n, s in rule.items()}
        assert got == want, model_size
        assert any(got.values()) and not all(got.values())
        # the numpy tree form gives the same marks
        assert {k: s == "model" for k, s in
                param_shardings(mesh, flat).items()} == want


def test_jax_sharded_step_does_not_lower_its_kernels_for_tpu(monkeypatch):
    """What GSPMD does with the JAX package's Pallas kernels under a mesh:
    its sharded train step on make_mesh(data=4, model=2), lowered for the
    TPU from this CPU (the backend reported as "tpu" while tracing, so
    that the step takes the kernels), stops at the first kernel: JAX
    does not partition a Mosaic call, and no all-gather of its operands
    is ever emitted. The port's mesh step gathers whole weights for its
    kernels instead (parallel/collectives.py)."""
    import jax.numpy as jnp

    from libreasr_tpu.parallel.mesh import place_state
    from libreasr_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from libreasr_tpu.training.learner import Batch as JaxBatch
    from libreasr_tpu.training.learner import Learner as JaxLearner
    from libreasr_tpu.training.learner import LossConfig as JaxLossConfig
    from libreasr_tpu.training.learner import init_carry
    from libreasr_tpu.training.optimizers import build_optimizer

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    cfg = JaxConfig(feature_sz=64, embed_sz=16, vocab_sz=128, hidden_sz=128,
                    out_sz=128, joint_sz=128, enc_num_layers=1, pred_num_layers=1,
                    enc_dropout=0.0, pred_dropout=0.0, compute_dtype=jnp.bfloat16)
    model, variables = init_transducer(cfg, jax.random.PRNGKey(0))
    mesh = jax_make_mesh(data=4, model=2)
    learner = JaxLearner(model, variables, build_optimizer("adam", 1e-3),
                         frontend=None, loss_cfg=JaxLossConfig(fused=True),
                         mesh=mesh)
    state = place_state(mesh, learner.state)
    n, t, u = 8, 32, 6
    batch = JaxBatch(*jax_shard_batch(mesh, (
        np.zeros((n, t, 64), np.float32), np.full((n,), t, np.int32),
        np.ones((n, u), np.int32), np.full((n,), u, np.int32))))
    traced = jax.jit(learner._raw_step).trace(state, init_carry(cfg, n), batch,
                                              jax.random.PRNGKey(0))
    with pytest.raises(NotImplementedError,
                       match="Mosaic kernels cannot be automatically partitioned"):
        traced.lower(lowering_platforms=("tpu",))


@pytest.mark.parametrize("shape,rank,axes", [
    ((2, 1, 1), 1, {"data": [0, 1]}),
    ((1, 2, 1), 0, {"model": [0, 1]}),
    ((2, 2, 1), 3, {"data": [1, 3], "model": [2, 3]}),
    ((1, 2, 2), 2, {"model": [0, 2], "pipe": [2, 3]}),
    ((1, 1, 1), 0, {}),
])
def test_axis_groups_only_on_axes_of_more_than_one_rank(monkeypatch, shape,
                                                        rank, axes):
    """A group along every axis of more than one rank, in JAX's rank
    layout, and none on an axis of one rank (GSPMD emits no collective
    over it): every rank asks for every group, in one order."""
    import torch.distributed as tdist

    from libreasr_tpu_torch.parallel.mesh import _axis_groups

    asked = []
    monkeypatch.setattr(tdist, "new_group",
                        lambda ranks: asked.append(ranks) or list(ranks))
    got = _axis_groups(*shape, rank)
    assert got == axes
    n = shape[0] * shape[1] * shape[2]
    assert len(asked) == sum(n // s for s in shape if s > 1)
