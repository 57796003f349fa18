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
def test_unported_optimizers_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        topt.build_optimizer(name, 1e-3)
    with pytest.raises(NotImplementedError, match="reduce_on_plateau"):
        topt.build_optimizer("adam", 1e-3, reduce_on_plateau=True)
