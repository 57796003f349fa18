"""The port's fused joint + RNN-T loss (ops/fused_loss.py) against the
JAX package's rnnt_loss_fused: loss and every gradient (encoder and
predictor outputs, the five joint parameters), on JAX's chunked XLA
path and with LIBREASR_FORCE_PALLAS=1 (its Pallas kernels F, G, H in
interpret mode, as tests/test_fused_loss.py runs them). The port runs
both of its routes on the CPU: the chunked path (what
rnnt_loss_fused takes for CPU tensors) and the kernel route, whose
wrappers take their plain twins for CPU tensors.

Tolerances: float32, the same sums in another order: loss 1e-5
relative, gradients 1e-4 of each tensor's largest entry. With a bf16
compute dtype both sides round the same matmul inputs to bf16, and an
ulp of order difference can flip a rounding: loss 1e-4, gradients 1e-2
of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libreasr_tpu.ops.fused_loss import JointParams as JaxJointParams
from libreasr_tpu.ops.fused_loss import rnnt_loss_fused as jax_fused
from libreasr_tpu_torch.ops import fused_loss as tfl


def _inputs(seed, n=3, t=13, u=8, h=12, j=24, v=40):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((n, t, h)).astype(np.float32)
    pred = rng.standard_normal((n, u + 1, h)).astype(np.float32)
    ps = [(rng.standard_normal(s) * 0.3).astype(np.float32)
          for s in ((h, j), (j,), (h, j), (j, v), (v,))]
    lab = rng.integers(1, v, (n, u)).astype(np.int32)
    lab[0, 2] = 0
    return enc, pred, ps, lab, np.array([t, 7, 1]), np.array([u, 3, 0])


def _jax(enc, pred, ps, lab, fl, yl, cdt):
    def go(e, p, jp):
        return jnp.sum(jax_fused(e, p, jp, jnp.asarray(lab), jnp.asarray(fl),
                                 jnp.asarray(yl), 0, 4, cdt) * jnp.arange(1, 4))

    val, g = jax.value_and_grad(go, argnums=(0, 1, 2))(
        jnp.asarray(enc), jnp.asarray(pred), JaxJointParams(*map(jnp.asarray, ps)))
    return float(val), [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(g)]


def _port(enc, pred, ps, lab, fl, yl, cdt, route):
    ts = [torch.tensor(x, requires_grad=True) for x in [enc, pred, *ps]]
    loss = tfl._fused(ts[0], ts[1], tfl.JointParams(*ts[2:]), torch.from_numpy(lab),
                      torch.from_numpy(fl), torch.from_numpy(yl), 0, 4, cdt, route)
    val = (loss * torch.arange(1, 4)).sum()
    val.backward()
    return float(val.detach()), [x.grad.numpy() for x in ts]


@pytest.mark.parametrize("force_pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("route", ["chunked", "kernels"])
def test_fused_loss_and_gradients_match_jax(route, force_pallas, monkeypatch):
    if force_pallas:
        monkeypatch.setenv("LIBREASR_FORCE_PALLAS", "1")
    inputs = _inputs(0)
    jv, jg = _jax(*inputs, None)
    tv, tg = _port(*inputs, None, route)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max())


def test_fused_loss_bf16_compute_matches_jax():
    inputs = _inputs(1)
    jv, jg = _jax(*inputs, jnp.bfloat16)
    tv, tg = _port(*inputs, torch.bfloat16, "chunked")
    np.testing.assert_allclose(tv, jv, rtol=1e-4)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-2 * np.abs(b).max())


def test_public_entry_takes_the_chunked_path_on_cpu(monkeypatch):
    """rnnt_loss_fused on CPU tensors never calls the kernel wrappers."""
    from libreasr_tpu_torch.ops.kernels import joint_lp as kj

    def boom(*a, **k):
        raise AssertionError("kernel route taken on the CPU")

    monkeypatch.setattr(kj, "joint_lp_fwd", boom)
    enc, pred, ps, lab, fl, yl = _inputs(2)
    ts = [torch.tensor(x, requires_grad=True) for x in [enc, pred, *ps]]
    loss = tfl.rnnt_loss_fused(ts[0], ts[1], tfl.JointParams(*ts[2:]),
                               torch.from_numpy(lab), torch.from_numpy(fl),
                               torch.from_numpy(yl), 0, 4)
    loss.sum().backward()
    assert torch.isfinite(loss).all() and ts[0].grad is not None
