"""The port's GPipe LSTM stack (parallel/pipeline.py) on four gloo ranks
(pipe 4, 4 microbatches) against the JAX package's sequential scan
stack on the same weights (tests/test_pipeline.py:35-84): the forward
with ragged lengths, the backward (input and every layer's gradients),
and the shape guards with JAX's messages.

Tolerances are JAX's own for its pipeline: forward 1e-5 relative and
1e-6 absolute, gradients 1e-4 relative and 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_dist import run_ranks
from libreasr_tpu.ops.rnn import init_lstm, lstm_scan
from libreasr_tpu_torch.ops.rnn import LSTMParams
from libreasr_tpu_torch.parallel.mesh import make_mesh
from libreasr_tpu_torch.parallel.pipeline import (pipeline_lstm_stack,
                                                  stack_layer_params)

H, T, N, L, STAGES, MICRO = 16, 10, 8, 4, 4, 4


def _sequential(layers, x, lengths):
    zero = (jnp.zeros((x.shape[0], H)), jnp.zeros((x.shape[0], H)))
    y = x
    for p in layers:
        y, _ = lstm_scan(y, zero, p, lengths=lengths)
    return y


def test_pipeline_forward_and_backward_match_jax_sequential(tmp_path, rng):
    layers = [init_lstm(r, H, H) for r in jax.random.split(jax.random.PRNGKey(0), L)]
    stacked = {f: np.stack([np.asarray(getattr(l, f)) for l in layers])
               for f in LSTMParams._fields}
    x = rng.standard_normal((N, T, H)).astype(np.float32)
    lengths = np.array([T, T - 1, T - 3, T, T - 2, T, T - 5, T])
    np.savez(tmp_path / "stack.npz", x=x, lengths=lengths, **stacked)
    run_ranks(tmp_path, {"scenario": "pipeline", "mesh": {"data": 1, "pipe": STAGES},
                         "stack": str(tmp_path / "stack.npz"), "n_micro": MICRO},
              world=STAGES)
    got = dict(np.load(tmp_path / "out" / "pipeline.npz"))

    def loss(params, x):
        seq = [type(layers[0])(*(a[i] for a in params)) for i in range(L)]
        return jnp.sum(_sequential(seq, x, jnp.asarray(lengths)) ** 2)

    params = tuple(jnp.asarray(stacked[f]) for f in LSTMParams._fields)
    want_y = _sequential(layers, jnp.asarray(x), jnp.asarray(lengths))
    np.testing.assert_allclose(got["y"], np.asarray(want_y), rtol=1e-5, atol=1e-6)
    g_params, g_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    np.testing.assert_allclose(got["dx"], np.asarray(g_x), rtol=1e-4, atol=1e-5)
    for f, g in zip(LSTMParams._fields, g_params):
        np.testing.assert_allclose(got[f"d_{f}"], np.asarray(g), rtol=1e-4,
                                   atol=1e-5, err_msg=f"grad mismatch in {f}")


def test_pipeline_shape_guards():
    gen = torch.Generator().manual_seed(0)
    layers = [LSTMParams(torch.randn(H, 4 * H, generator=gen),
                         torch.randn(H, 4 * H, generator=gen), torch.zeros(4 * H))
              for _ in range(L)]
    stacked = stack_layer_params(layers)
    assert stacked.kernel.shape == (L, H, 4 * H)
    mesh = make_mesh(data=1, pipe=STAGES, devices=["cpu"] * STAGES)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_lstm_stack(stacked, torch.zeros(N, T, H), mesh=mesh, n_micro=3)
    with pytest.raises(ValueError, match="uniform"):
        pipeline_lstm_stack(stacked, torch.zeros(N, T, H + 2), mesh=mesh,
                            n_micro=MICRO)
    with pytest.raises(ValueError, match="not divisible by"):
        pipeline_lstm_stack(stack_layer_params(layers[:3]), torch.zeros(N, T, H),
                            mesh=mesh, n_micro=MICRO)
