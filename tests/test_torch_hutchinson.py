"""Second-order training in the port against the JAX package: the RNN-T
loss through autograd (value, gradient, Hessian-vector products), the
Learner's Hutchinson step for AdaHessian with JAX's probes injected, the
refusal on the D/E route, the loss handed to reduce_on_plateau, and the
chained step.

Tolerances:
- rnnt_loss_autodiff against rnnt_loss and JAX's: values 1e-5 relative
  and gradients 1e-5 absolute (the same float32 DP; measured 9.5e-7);
- the HVP against central finite differences of the gradient: 5e-2
  relative, 5e-3 absolute, as tests/test_adahessian.py:96-99 holds JAX's
  (the differences' own float32 error at eps 1e-3); against JAX's JVP of
  the gradient: 1e-4 of the largest entry (reverse-over-reverse against
  forward-over-reverse, the same float32 terms summed in another order);
- Learner steps: losses 1e-5 relative, parameters 2e-5 absolute, as
  tests/test_torch_train.py holds its ranger steps (the update is
  lr-sized and normalised);
- the chained step: bit for bit (the same ops in the same order).
"""

import copy

import numpy as np
import pytest
import torch

from libreasr_tpu_torch.ops import rnnt_loss as trl
from libreasr_tpu_torch.training import optimizers as topt
from libreasr_tpu_torch.training.learner import Batch, Learner, LossConfig
from test_torch_train import (TINY, _batches, _flat_jax, _flat_port, _jax_batch,
                              _models, _torch_batch)


def _lattice(seed, n=3, t=7, u1=5, v=11):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, t, u1, v)).astype(np.float32)
    labels = rng.integers(1, v, (n, u1 - 1)).astype(np.int32)
    return logits, labels


def test_autodiff_loss_matches_rnnt_loss_and_jax():
    import jax
    import jax.numpy as jnp

    from libreasr_tpu.ops.rnnt_loss import rnnt_loss_autodiff as jax_autodiff

    logits, labels = _lattice(0)
    fl, yl = np.array([7, 4, 1]), np.array([4, 2, 0])
    x = torch.tensor(logits, requires_grad=True)
    args = (torch.from_numpy(labels), torch.from_numpy(fl), torch.from_numpy(yl))
    ref = trl.rnnt_loss(x, *args)
    (g_ref,) = torch.autograd.grad(ref.sum(), x)
    out = trl.rnnt_loss_autodiff(x, *args)
    (g_out,) = torch.autograd.grad(out.sum(), x)
    jv, jg = jax.value_and_grad(lambda lg: jnp.sum(jax_autodiff(
        lg, jnp.asarray(labels), jnp.asarray(fl), jnp.asarray(yl))))(
        jnp.asarray(logits))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), rtol=1e-5)
    np.testing.assert_allclose(float(out.detach().sum()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(g_out.numpy(), g_ref.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(g_out.numpy(), np.asarray(jg), rtol=0, atol=1e-5)


def test_autodiff_loss_hvp_matches_finite_differences_and_jax():
    """H z by a second backward through rnnt_loss_autodiff (what the
    Hutchinson step computes) against central differences of the
    gradient, and against JAX's forward-over-reverse HVP."""
    import jax
    import jax.numpy as jnp

    from libreasr_tpu.ops.rnnt_loss import rnnt_loss_autodiff as jax_autodiff

    logits, labels = _lattice(1, n=2, t=5, u1=4, v=8)
    fl, yl = np.array([5, 4]), np.array([3, 2])
    z = np.random.default_rng(2).standard_normal(logits.shape).astype(np.float32)
    args = (torch.from_numpy(labels), torch.from_numpy(fl), torch.from_numpy(yl))

    def grad(lg, create_graph=False):
        x = lg if lg.requires_grad else lg.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(trl.rnnt_loss_autodiff(x, *args).sum(), x,
                                   create_graph=create_graph)
        return g

    x = torch.tensor(logits, requires_grad=True)
    (hz,) = torch.autograd.grad(grad(x, True), x, grad_outputs=torch.from_numpy(z))
    eps = 1e-3
    tz = torch.from_numpy(z)
    fd = (grad(torch.from_numpy(logits) + eps * tz)
          - grad(torch.from_numpy(logits) - eps * tz)) / (2 * eps)
    np.testing.assert_allclose(hz.numpy(), fd.numpy(), rtol=5e-2, atol=5e-3)

    def jloss(lg):
        return jnp.sum(jax_autodiff(lg, jnp.asarray(labels), jnp.asarray(fl),
                                    jnp.asarray(yl)))

    _, jhz = jax.jvp(jax.grad(jloss), (jnp.asarray(logits),), (jnp.asarray(z),))
    scale = float(np.abs(np.asarray(jhz)).max())
    np.testing.assert_allclose(hz.numpy(), np.asarray(jhz), rtol=0, atol=1e-4 * scale)


def _jax_probes(jl, tmodel):
    """The Rademacher probes JAX's next Hutchinson step draws (from the
    learner's next key, fold_in 99, one split per parameter leaf), in the
    port's parameter order."""
    import jax

    _, key = jax.random.split(jl._rng)
    rng_z = jax.random.fold_in(key, 99)
    leaves = jax.tree_util.tree_leaves_with_path(jl.state.params)
    keys = jax.random.split(rng_z, len(leaves))
    by_name = {}
    for (path, leaf), k in zip(leaves, keys):
        name = ".".join(str(getattr(p, "key", getattr(p, "name", ""))) for p in path)
        by_name[name] = np.asarray(jax.random.rademacher(k, leaf.shape, leaf.dtype))
    return [torch.from_numpy(by_name[n].copy()) for n, _ in tmodel.named_parameters()]


@pytest.mark.parametrize("plateau", [False, True], ids=["adahessian", "with_plateau"])
def test_hutchinson_steps_match_jax(plateau):
    """Three AdaHessian steps with JAX's probes injected: the loss of each
    step and the parameters after steps 1 and 3; with reduce_on_plateau
    the loss is handed to the optimizer on both sides.

    The chain is build_optimizer's (clip 1.0, adahessian, the plateau
    scaling) with adahessian's eps at 1.0 in place of 1e-4: its first
    step is g / (|z H z| + eps), and an element of z H z summed from
    terms far larger than itself carries a float32 summation-order error
    of ~1e-5 absolute, which a small eps turns into a visible step
    difference (measured: eps 1e-4, one element of 192 moved 1.7e-4
    apart; eps 1e-2, one of 1,280 moved 3.4e-5). At eps 1.0 the step
    still reads z H z (here |z H z| has its median at 1.0, its 5th
    percentile at 0.036 and its largest entry at 108) but the error
    stays below the parameter tolerance. build_optimizer's own
    adahessian is held by tests/test_torch_optim.py."""
    import optax

    from libreasr_tpu.training import optimizers as jo
    from libreasr_tpu.training.learner import Learner as JaxLearner
    from libreasr_tpu.training.learner import LossConfig as JaxLossConfig

    jparts = [optax.clip_by_global_norm(1.0), jo.adahessian(1e-2, eps=1.0)]
    tparts = [topt.clip_by_global_norm(1.0), topt.adahessian(1e-2, eps=1.0)]
    if plateau:
        kw = dict(factor=0.5, patience=10, cooldown=5, accumulation_size=50)
        jparts.append(optax.contrib.reduce_on_plateau(**kw))
        tparts.append(topt.plateau_scale(**kw))
    jmodel, jvars, tmodel = _models(TINY)
    jl = JaxLearner(jmodel, jvars, optax.chain(*jparts), frontend=None,
                    loss_cfg=JaxLossConfig(fused=False), seed=0,
                    hutchinson=True, pass_loss_value=plateau)
    tl = Learner(tmodel, topt.chain(*tparts), None, LossConfig(fused=False),
                 seed=0, hutchinson=True, pass_loss_value=plateau)
    for i, b in enumerate(_batches(np.random.default_rng(6), 3)):
        probes = _jax_probes(jl, tl.model)
        tl.probes = lambda probes=probes: probes
        jm = jl.step(_jax_batch(b))
        tm = tl.step(_torch_batch(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        if i in (0, 2):
            jp, tp = _flat_jax(jl.state.params), _flat_port(tl.model, "params")
            for k in jp:
                np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=2e-5,
                                           err_msg=f"step {i}: {k}")
    if plateau:
        state = tl.state.opt_state[2]
        assert state["count"] == 3
        np.testing.assert_allclose(float(state["avg_value"]),
                                   float(jl.state.opt_state[2].avg_value), rtol=1e-5)


def test_learner_from_config_wires_hutchinson_and_plateau():
    """An adahessian config trains with Hutchinson probes, and
    reduce_on_plateau hands the loss to the optimizer, as JAX's train.py
    wires them (its :146-161)."""
    conf = copy.deepcopy(TINY)
    conf["training"] = {"optimizer": "adahessian", "reduce_on_plateau": True}
    tl = Learner.from_config(conf, device="cpu")
    tl.frontend = None  # the batches are features
    assert tl.hutchinson and tl.pass_loss_value
    assert all(m.second_order for m in tl.model.modules()
               if type(m).__name__ == "RNNLayer")
    m = tl.step(_torch_batch(_batches(np.random.default_rng(9), 1)[0]))
    assert bool(m["finite"]) and float(tl.state.opt_state[2]["avg_value"]) == float(m["loss"])
    conf["training"] = {"optimizer": "adam"}
    plain = Learner.from_config(conf, device="cpu")
    assert not plain.hutchinson and not plain.pass_loss_value


def test_hutchinson_on_train_kernel_route_raises():
    """With use_pallas_train (the default) and T >= 16 the encoder trains
    on kernels D and E, which have no double backward: the step raises,
    naming the setting that takes the scan cells (JAX's Pallas kernel D
    has no JVP: ROADMAP, "Not faults of the port")."""
    conf = copy.deepcopy(TINY)
    conf["model"]["encoder"]["use_pallas_train"] = True
    _, _, tmodel = _models(conf)
    tl = Learner(tmodel, topt.build_optimizer("adahessian", 1e-2), None,
                 LossConfig(fused=False), hutchinson=True)
    b = _batches(np.random.default_rng(7), 1, t=20)[0]
    with pytest.raises(ValueError, match="use_pallas_train: false"):
        tl.step(_torch_batch(b))
    # a first-order Learner on the same model takes the kernel route
    first = Learner(tmodel, topt.build_optimizer("adam", 1e-2), None,
                    LossConfig(fused=False))
    assert np.isfinite(float(first.step(_torch_batch(b))["loss"]))


def _audio_batches(k, n=3, s=9000, u=4, v=13, seed=8):
    rng = np.random.default_rng(seed)
    return [Batch(torch.from_numpy((rng.standard_normal((n, s)) * 0.1).astype(np.float32)),
                  torch.tensor([s, s - 2000, s - 5000]),
                  torch.from_numpy(rng.integers(1, v, (n, u)).astype(np.int32)),
                  torch.tensor([u, u - 1, 2]))
            for _ in range(k)]


def _augmenting_learner():
    """A seeded Learner whose steps draw from both generators: SpecAugment
    on raw audio, dropout, and the carry draw."""
    from libreasr_tpu_torch.models.transducer import Transducer, TransducerConfig
    from libreasr_tpu_torch.ops.frontend import FrontendConfig

    conf = copy.deepcopy(TINY)
    conf["model"]["feature_sz"] = 1280
    conf["model"]["encoder"].update(dropout=0.1, use_tmp_state_pcent=0.5)
    model = Transducer(TransducerConfig.from_config(conf), seed=4)
    return Learner(model, topt.build_optimizer("ranger", 1e-2), FrontendConfig(),
                   LossConfig(fused=True, t_chunk=4), seed=4)


def test_step_chained_equals_k_steps():
    """step_chained on 3 batches leaves the model, optimizer state, carry
    and generators as 3 step() calls do, bit for bit; its metrics are the
    last step's plus loss_mean. One batch is a plain step; mixed shapes
    raise, as in JAX."""
    batches = _audio_batches(4)
    a, b = _augmenting_learner(), _augmenting_learner()
    chained = a.step_chained(batches[:3])
    singles = [b.step(x) for x in batches[:3]]
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert torch.equal(va, vb), ka
    assert float(chained["loss"]) == float(singles[-1]["loss"])
    assert float(chained["loss_mean"]) == float(
        torch.stack([m["loss"] for m in singles]).mean())
    assert torch.equal(a.gen.get_state(), b.gen.get_state())
    assert torch.equal(a.host_gen.get_state(), b.host_gen.get_state())
    one = a.step_chained(batches[3:])
    assert "loss_mean" not in one
    assert float(one["loss"]) == float(b.step(batches[3])["loss"])
    short = _audio_batches(1, s=7000)[0]
    with pytest.raises(ValueError, match="one bucket shape"):
        a.step_chained([batches[0], short])
