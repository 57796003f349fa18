"""The port's optimizers (training/optimizers.py) against the JAX
package's build_optimizer (optax) over 16 steps: ranger, adam, adamw
and sgd, with global-norm clipping that triggers on some steps, the
warmup-cosine schedule, and with and without MultiSteps accumulation.
16 steps cross lookahead's sync (every 6 inner steps) and radam's
variance threshold (from its 6th inner step on).

Tolerances: the port computes the scalar factors (bias corrections,
the radam rectifier, the schedule) in float64 on the host, optax in
float32: parameters of size ~1 agree to 2e-5 after 16 steps, and the
schedule's values to float32 rounding (1e-5 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from libreasr_tpu.training.optimizers import build_optimizer as jax_build
from libreasr_tpu.training.optimizers import make_lr_schedule as jax_schedule
from libreasr_tpu_torch.training import optimizers as topt

SHAPES = [(5, 3), (7,), (2, 2, 2)]


@pytest.mark.parametrize("accumulate", [1, 2])
@pytest.mark.parametrize("name", ["ranger", "adam", "adamw", "sgd"])
def test_matches_optax(name, accumulate):
    rng = np.random.default_rng(len(name) + accumulate)
    conf = {"lr": 1e-2, "total_steps": 12, "warmup_pct": 0.25}
    jtx = jax_build(name, jax_schedule(conf), weight_decay=0.05, grad_clip=2.0,
                    accumulate=accumulate)
    ttx = topt.build_optimizer(name, topt.make_lr_schedule(conf),
                               weight_decay=0.05, grad_clip=2.0,
                               accumulate=accumulate)
    ps = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    jp, tp = [jnp.asarray(p) for p in ps], [torch.from_numpy(p.copy()) for p in ps]
    js, ts = jtx.init(jp), ttx.init(tp)
    jupdate = jax.jit(jtx.update)
    for i in range(16 * accumulate):
        scale = 3.0 if i % 4 == 0 else 0.1  # clipped on every 4th step
        gs = [(rng.standard_normal(s) * scale).astype(np.float32) for s in SHAPES]
        u, js = jupdate([jnp.asarray(g) for g in gs], js, jp)
        jp = optax.apply_updates(jp, u)
        u2, ts = ttx.update([torch.from_numpy(g) for g in gs], ts, tp)
        topt.apply_updates(tp, u2)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-5)


def test_schedule_matches_optax():
    conf = {"lr": 5e-4, "total_steps": 40, "warmup_pct": 0.3}
    js, ts = jax_schedule(conf), topt.make_lr_schedule(conf)
    for c in (0, 1, 5, 11, 12, 13, 25, 39, 40, 60):
        np.testing.assert_allclose(ts(c), float(js(c)), rtol=1e-5)


@pytest.mark.parametrize("name", ["lamb", "apollo", "adahessian", "ranger_adabelief"])
def test_every_optimizer_builds_and_unknown_name_raises(name):
    """Each of these optimizers, and reduce_on_plateau, builds and takes
    a step; only an unknown name raises."""
    tx = topt.build_optimizer(name, 1e-3)
    params = [torch.ones(3)]
    ups, _ = tx.update([torch.full((3,), 0.5)], tx.init(params), params)
    assert float(ups[0].abs().max()) > 0
    plateau = topt.build_optimizer("adam", 1e-3, reduce_on_plateau=True)
    ups, state = plateau.update([torch.ones(3)], plateau.init(params), params,
                                value=torch.tensor(2.0))
    assert float(state[2]["avg_value"]) == 2.0 and state[2]["count"] == 1
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.build_optimizer(name + "x", 1e-3)


MORE_SHAPES = [(5, 3), (7,), (2, 2, 2), (4,)]


@pytest.mark.parametrize("accumulate", [1, 2])
@pytest.mark.parametrize("name", ["ranger_adabelief", "lamb", "over9000",
                                  "apollo", "adahessian"])
def test_more_optimizers_match_optax(name, accumulate):
    """The optimizers the JAX package chains itself or takes from optax,
    over 24 updates: every update, then the parameters. The last
    parameter starts at 0, so lamb's trust ratio takes its zero-norm
    branch; adahessian gets a random hessian_diag each call (MultiSteps
    hands the k-th call's to it, on both sides); the schedule warms up
    and decays; clipping triggers on every 4th call. Tolerance 2e-5, as
    above: scalars in float64 here, float32 in optax."""
    rng = np.random.default_rng(len(name) * 7 + accumulate)
    conf = {"lr": 1e-2, "total_steps": 20, "warmup_pct": 0.25}
    jtx = jax_build(name, jax_schedule(conf), weight_decay=0.05, grad_clip=2.0,
                    accumulate=accumulate)
    ttx = topt.build_optimizer(name, topt.make_lr_schedule(conf),
                               weight_decay=0.05, grad_clip=2.0,
                               accumulate=accumulate)
    ps = [rng.standard_normal(s).astype(np.float32) for s in MORE_SHAPES]
    ps[-1][:] = 0.0
    jp, tp = [jnp.asarray(p) for p in ps], [torch.from_numpy(p.copy()) for p in ps]
    js, ts = jtx.init(jp), ttx.init(tp)
    jupdate = jax.jit(jtx.update)
    for i in range(24 * accumulate):
        scale = 3.0 if i % 4 == 0 else 0.1
        gs = [(rng.standard_normal(s) * scale).astype(np.float32)
              for s in MORE_SHAPES]
        jkw, tkw = {}, {}
        if name == "adahessian":
            hd = [rng.standard_normal(s).astype(np.float32) for s in MORE_SHAPES]
            jkw["hessian_diag"] = [jnp.asarray(h) for h in hd]
            tkw["hessian_diag"] = [torch.from_numpy(h) for h in hd]
        ju, js = jupdate([jnp.asarray(g) for g in gs], js, jp, **jkw)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update([torch.from_numpy(g) for g in gs], ts, tp, **tkw)
        topt.apply_updates(tp, tu)
        for a, b in zip(tu, ju):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=2e-5, err_msg=f"update {i}")
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-5)
    assert float(np.abs(np.asarray(jp[-1])).max()) > 0


def test_plateau_scale_matches_optax_past_patience_and_cooldown():
    """The plateau transform against optax.contrib.reduce_on_plateau at
    small settings (accumulation 2, patience 3, cooldown 2): losses that
    improve, then stall; the scale halves three times, and every update,
    scale, best value and counter agree. The values are float32 on both
    sides and the averaging the same: exact."""
    kw = dict(factor=0.5, patience=3, cooldown=2, accumulation_size=2)
    jtx = optax.contrib.reduce_on_plateau(**kw)
    ttx = topt.plateau_scale(**kw)
    p = [np.ones(3, np.float32)]
    js, ts = jtx.init([jnp.asarray(x) for x in p]), ttx.init([torch.ones(3)])
    rng = np.random.default_rng(0)
    for i in range(40):
        value = np.float32(5.0 - 0.5 * i if i < 8 else 1.0)
        g = rng.standard_normal(3).astype(np.float32)
        ju, js = jtx.update([jnp.asarray(g)], js, value=jnp.asarray(value))
        tu, ts = ttx.update([torch.from_numpy(g)], ts, value=torch.tensor(value))
        np.testing.assert_array_equal(tu[0].numpy(), np.asarray(ju[0]))
        for field in ("best_value", "plateau_count", "scale", "cooldown_count",
                      "avg_value"):
            assert float(ts[field]) == float(getattr(js, field)), (i, field)
        assert ts["count"] == int(js.count)
    assert float(ts["scale"]) == 0.5 ** 3


def test_build_optimizer_reduce_on_plateau_matches_jax():
    """build_optimizer(reduce_on_plateau=True) as the JAX package builds
    it (factor 0.5, patience 10, cooldown 5, 50 losses a mean), fed a
    falling then flat loss for 800 steps: the scale falls on both sides
    at the same steps, and the parameters agree (tolerance 2e-5, as
    above)."""
    jtx = jax_build("adam", 1e-3, grad_clip=2.0, reduce_on_plateau=True)
    ttx = topt.build_optimizer("adam", 1e-3, grad_clip=2.0, reduce_on_plateau=True)
    rng = np.random.default_rng(1)
    p = rng.standard_normal(4).astype(np.float32)
    jp, tp = [jnp.asarray(p)], [torch.from_numpy(p.copy())]
    js, ts = jtx.init(jp), ttx.init(tp)
    jupdate = jax.jit(jtx.update)
    scales = []
    for i in range(800):
        value = np.float32(3.0 - 0.01 * i if i < 100 else 2.0)
        g = rng.standard_normal(4).astype(np.float32)
        ju, js = jupdate([jnp.asarray(g)], js, jp, value=jnp.asarray(value))
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update([torch.from_numpy(g)], ts, tp,
                            value=torch.tensor(value))
        topt.apply_updates(tp, tu)
        assert float(ts[2]["scale"]) == float(js[2].scale), i
        scales.append(float(ts[2]["scale"]))
    assert min(scales) < 1.0
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp[0]), rtol=0, atol=2e-5)
