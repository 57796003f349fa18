"""The port's Learner against the JAX package's, on a tiny model.

Both start from the same JAX-initialised variables (carried across with
`convert.load_jax_variables`) and take the same feature batches, made
with numpy. Settings that make the two runs deterministic alike:
float32 compute (no bf16 rounding), dropout 0, no SpecAugment (batches
are features), use_tmp_state_pcent 1.0 (from step 2 on, the carry is
always taken), use_pallas_train false (the JAX encoder trains on its
scan cells, as the port's does).

Gradients are read off one step of plain SGD with learning rate 1 and
no momentum, on both sides: grad = params_before - params_after.

Tolerances: the two sides take the same float32 sums in another order
(the RNN-T DP runs over anti-diagonals in the port, a scan of
associative scans in JAX; matmuls block differently): about 1e-6
relative per op. Gradients are held at 1e-4 of each tensor's largest
entry; parameters after three ranger steps at 2e-5 absolute (the
radam step is lr-sized, 1e-2 here, and its normalised direction moves
by at most ~1e-3 relative where a moment is tiny); losses at 1e-5
relative; batch statistics at 1e-5.
"""

import copy

import jax
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from libreasr_tpu.models.transducer import Transducer as JaxTransducer
from libreasr_tpu.models.transducer import TransducerConfig as JaxConfig
from libreasr_tpu.models.transducer import init_transducer
from libreasr_tpu.training.checkpoint import load_bundle as jax_load_bundle
from libreasr_tpu.training.learner import Batch as JaxBatch
from libreasr_tpu.training.learner import Learner as JaxLearner
from libreasr_tpu.training.learner import LossConfig as JaxLossConfig
from libreasr_tpu.training.optimizers import build_optimizer as jax_build_optimizer
from libreasr_tpu.training.optimizers import make_lr_schedule as jax_schedule
from libreasr_tpu_torch.checkpoint import save_bundle
from libreasr_tpu_torch.convert import export_variables, flatten_variables, load_jax_variables
from libreasr_tpu_torch.models.transducer import Transducer, TransducerConfig
from libreasr_tpu_torch.training import optimizers as topt
from libreasr_tpu_torch.training.learner import Batch, Learner, LossConfig

TINY = {
    "model": {
        "feature_sz": 20, "embed_sz": 8, "vocab_sz": 13, "hidden_sz": 16,
        "out_sz": 12, "joint_sz": 10, "joint": {"method": "concat"},
        "encoder": {"rnn_type": "LSTM", "num_layers": 2, "dropout": 0.0,
                    "use_pallas_train": False, "use_tmp_state_pcent": 1.0},
        "predictor": {"rnn_type": "NBRC", "num_layers": 1, "dropout": 0.0},
    },
    "dtypes": {"compute": "float32"},
}


def _models(conf, seed=0):
    jcfg = JaxConfig.from_config(conf)
    jmodel, jvars = init_transducer(jcfg, jax.random.PRNGKey(seed))
    tree = serialization.to_state_dict(jax.tree_util.tree_map(np.asarray, jvars))
    tmodel = Transducer(TransducerConfig.from_config(conf))
    load_jax_variables(tmodel, tree)
    return jmodel, jvars, tmodel


def _batches(rng, k, n=3, t=14, u=5, f=20, v=13):
    out = []
    for _ in range(k):
        out.append((
            rng.standard_normal((n, t, f)).astype(np.float32),
            np.array([t, t - 3, t - 6]),
            rng.integers(1, v, (n, u)).astype(np.int32),
            np.array([u, u - 2, 1]),
        ))
    return out


def _jax_batch(b):
    return JaxBatch(*(jax.numpy.asarray(x) for x in b))


def _torch_batch(b):
    return Batch(*(torch.from_numpy(np.asarray(x)) for x in b))


def _flat_jax(tree):
    return flatten_variables(serialization.to_state_dict(
        jax.tree_util.tree_map(np.asarray, tree)))


def _flat_port(model, collection):
    return flatten_variables(export_variables(model)[collection])


def _learners(fused, jtx, ttx, seed=0, conf=TINY):
    jmodel, jvars, tmodel = _models(conf, seed)
    lc = dict(fused=fused, t_chunk=4)
    jl = JaxLearner(jmodel, jvars, jtx, frontend=None,
                    loss_cfg=JaxLossConfig(**lc), seed=seed)
    tl = Learner(tmodel, ttx, None, LossConfig(**lc), seed=seed)
    return jl, tl


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "lattice"])
def test_learner_steps_match_jax(fused):
    """Three ranger steps with clipping and a schedule: loss at every
    step, then parameters and batch statistics after steps 1 and 3."""
    conf = {"lr": 1e-2, "total_steps": 10, "warmup_pct": 0.3}
    jtx = jax_build_optimizer("ranger", jax_schedule(conf), grad_clip=1.0)
    ttx = topt.build_optimizer("ranger", topt.make_lr_schedule(conf), grad_clip=1.0)
    jl, tl = _learners(fused, jtx, ttx)
    for i, b in enumerate(_batches(np.random.default_rng(1), 3)):
        jm = jl.step(_jax_batch(b))
        tm = tl.step(_torch_batch(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        assert bool(tm["finite"]) and bool(jm["finite"])
        assert int(tm["tokens"]) == int(jm["tokens"])
        if i in (0, 2):
            jp, tp = _flat_jax(jl.state.params), _flat_port(tl.model, "params")
            assert set(jp) == set(tp)
            for k in jp:
                np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=2e-5, err_msg=k)
            js = _flat_jax(jl.state.batch_stats)
            ts = _flat_port(tl.model, "batch_stats")
            assert set(js) == set(ts) and js
            for k in js:
                np.testing.assert_allclose(ts[k], js[k], rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "lattice"])
def test_learner_gradients_match_jax(fused):
    """Every gradient of steps 1 (from the learnable h0) and 2 (from the
    carried states), h0 included, read off plain SGD with lr 1."""
    jl, tl = _learners(fused, optax.sgd(1.0), topt.sgd(1.0, momentum=0.0))
    for step, b in enumerate(_batches(np.random.default_rng(2), 2)):
        jp0, tp0 = _flat_jax(jl.state.params), _flat_port(tl.model, "params")
        jl.step(_jax_batch(b))
        tl.step(_torch_batch(b))
        jp1, tp1 = _flat_jax(jl.state.params), _flat_port(tl.model, "params")
        for k in jp0:
            jg, tg = jp0[k] - jp1[k], tp0[k] - tp1[k]
            scale = max(float(np.abs(jg).max()), 1e-6)
            np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-4 * scale,
                                       err_msg=f"step {step}: {k}")
            if step == 0 and k.endswith("h0"):
                assert np.abs(tg).max() > 0, k


def test_accumulation_updates_on_boundaries_only():
    conf = {"lr": 1e-2, "total_steps": 10}
    ttx = topt.build_optimizer("ranger", topt.make_lr_schedule(conf), accumulate=2)
    jtx = jax_build_optimizer("ranger", jax_schedule(conf), accumulate=2)
    jl, tl = _learners(True, jtx, ttx)
    before = _flat_port(tl.model, "params")
    for i, b in enumerate(_batches(np.random.default_rng(3), 4)):
        jl.step(_jax_batch(b))
        tl.step(_torch_batch(b))
        now = _flat_port(tl.model, "params")
        changed = any(not np.array_equal(now[k], before[k]) for k in now)
        assert changed == (i % 2 == 1), i
        before = now
    jp = _flat_jax(jl.state.params)
    for k in jp:
        np.testing.assert_allclose(now[k], jp[k], rtol=0, atol=2e-5, err_msg=k)


def test_finite_gate_zeroes_grads_and_still_steps():
    """A NaN in the features makes the loss non-finite: every gradient is
    zeroed, the optimizer still steps (adam's count advances, zero
    moments move nothing), as in JAX."""
    jl, tl = _learners(True, jax_build_optimizer("adam", 1e-2),
                       topt.build_optimizer("adam", 1e-2))
    b = list(_batches(np.random.default_rng(4), 1)[0])
    b[0] = b[0].copy()
    b[0][1, 3, 2] = np.nan
    before = _flat_port(tl.model, "params")
    jm = jl.step(_jax_batch(b))
    tm = tl.step(_torch_batch(b))
    assert not bool(tm["finite"]) and not bool(jm["finite"])
    assert float(tm["grad_norm"]) == 0.0 == float(jm["grad_norm"])
    after = _flat_port(tl.model, "params")
    assert all(np.array_equal(after[k], before[k]) for k in before)
    assert tl.state.opt_state[1]["count"] == 1 and tl.state.step == 1
    jp = _flat_jax(jl.state.params)
    assert all(np.array_equal(after[k], jp[k]) for k in jp)


def test_port_trained_bundle_loads_in_jax(tmp_path):
    """One port train step, saved with the port's save_bundle: the JAX
    package's load_bundle reads it (batch statistics included) and its
    lattice logits equal the port's on the same input."""
    conf = copy.deepcopy(TINY)
    jmodel, jvars, tmodel = _models(conf)
    tl = Learner(tmodel, topt.build_optimizer("adam", 1e-2), None,
                 LossConfig(fused=True, t_chunk=4))
    b = _batches(np.random.default_rng(5), 1)[0]
    tl.step(_torch_batch(b))
    path = save_bundle(str(tmp_path / "m.tar.gz"), "en",
                       export_variables(tl.model), conf)
    loaded, _, _, _ = jax_load_bundle(path, "en", jvars,
                                      extract_to=str(tmp_path / "x"))
    x, xl, y, yl = b
    jlog, _ = jmodel.apply(loaded, jax.numpy.asarray(x), jax.numpy.asarray(y),
                           jax.numpy.asarray(xl), jax.numpy.asarray(yl))
    tl.model.eval()
    with torch.no_grad():
        tlog, _ = tl.model(torch.from_numpy(x), torch.from_numpy(y).long(),
                           torch.from_numpy(xl), torch.from_numpy(yl))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=1e-4)
    js = _flat_jax(loaded["batch_stats"])
    ts = _flat_port(tl.model, "batch_stats")
    assert all(np.array_equal(ts[k], js[k]) for k in js)


def test_learner_on_train_kernels_matches_jax(monkeypatch):
    """use_pallas_train: true at T 20 (>= 16): the port's encoder trains
    through LSTMTrainCore (kernels D and E; their twins on the CPU), the
    JAX encoder through its Pallas kernels in interpret mode
    (LIBREASR_FORCE_PALLAS=1). Every gradient of steps 1 and 2, read off
    plain SGD with lr 1 as above: step 1 at 1e-4 of each tensor's largest
    entry, as above; step 2 at 1e-3, because lr-1 SGD moves each weight by
    its whole step-1 gradient and so carries step 1's float32 rounding
    into step 2 scaled up (these batches, at T 20, measure 3.2e-4 on the
    scan route and 3.0e-4 on the kernel route, both on the predictor)."""
    from libreasr_tpu_torch.ops.kernels import lstm_train as klt

    monkeypatch.setenv("LIBREASR_FORCE_PALLAS", "1")
    calls = []
    real = klt.lstm_train_fwd
    monkeypatch.setattr(klt, "lstm_train_fwd",
                        lambda *a: calls.append(1) or real(*a))
    conf = copy.deepcopy(TINY)
    conf["model"]["encoder"]["use_pallas_train"] = True
    jl, tl = _learners(True, optax.sgd(1.0), topt.sgd(1.0, momentum=0.0),
                       conf=conf)
    for step, b in enumerate(_batches(np.random.default_rng(6), 2, t=20)):
        jp0, tp0 = _flat_jax(jl.state.params), _flat_port(tl.model, "params")
        jm = jl.step(_jax_batch(b))
        tm = tl.step(_torch_batch(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        jp1, tp1 = _flat_jax(jl.state.params), _flat_port(tl.model, "params")
        for k in jp0:
            jg, tg = jp0[k] - jp1[k], tp0[k] - tp1[k]
            scale = max(float(np.abs(jg).max()), 1e-6)
            np.testing.assert_allclose(tg, jg, rtol=0,
                                       atol=(1e-4, 1e-3)[step] * scale,
                                       err_msg=f"step {step}: {k}")
    assert len(calls) == 4  # 2 encoder layers x 2 steps
