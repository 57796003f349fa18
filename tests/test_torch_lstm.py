"""The port's LSTM sequence twin and scan cells against the JAX package.

- `lstm_seq_reference` (the CUDA kernel's plain twin) and `lstm_pack`
  against the Pallas kernels run in interpret mode, as
  tests/test_pallas_lstm.py runs them: kernel A (`lstm_seq_pallas`),
  kernel B (`_lstm_seq_pallas_cseq`) and `lstm_pack_pallas`.
  Tolerance: both sides hold R and h in bf16 and accumulate in float32,
  so they differ only in summation order; that difference can flip the
  bf16 rounding of an element of h, which moves the next step's gates
  by |R| * 2**-8 * |h| (~1e-4 at these widths). Bound: 1e-3 absolute.
- `lstm_scan` and `gru_scan` (pack and haste modes) against ops/rnn.py.
  In float32 both are plain matmuls and pointwise math: 1e-5. With a
  bf16 compute type both round the operands the same way and
  accumulate in float32; bf16 flips of h as above: 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libreasr_tpu.ops import rnn as jrnn
from libreasr_tpu.ops.pallas import lstm as jpl
from libreasr_tpu_torch.ops import rnn as trnn
from libreasr_tpu_torch.ops.kernels import lstm as tk

SEQ_TOL = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


def _seq_inputs(seed, n, t, h):
    rng = np.random.default_rng(seed)
    wx = rng.standard_normal((n, t, 4 * h)).astype(np.float32)
    r = (rng.standard_normal((h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    h0 = (rng.standard_normal((n, h)) * 0.5).astype(np.float32)
    c0 = (rng.standard_normal((n, h)) * 0.5).astype(np.float32)
    return wx, r, h0, c0


@pytest.mark.parametrize("n,t,h", [(3, 9, 96), (5, 6, 128), (4, 1, 96)])
def test_twin_matches_pallas_seq_kernels(n, t, h):
    wx, r, h0, c0 = _seq_inputs(n * 100 + t, n, t, h)
    y, yc, ht, ct = tk.lstm_seq_reference(_t(wx), _t(r), _t(h0), _t(c0), True)
    y_a, yc_a, ht_a, ct_a = tk.lstm_seq(_t(wx), _t(r), _t(h0), _t(c0))
    assert yc_a is None

    jy, (jht, jct) = jpl.lstm_seq_pallas(wx, r, h0, c0, interpret=True)
    _close(y_a, jy, SEQ_TOL)
    _close(ht_a, jht, SEQ_TOL)
    _close(ct_a, jct, SEQ_TOL)
    jy2, jyc = jpl._lstm_seq_pallas_cseq(wx, r, h0, c0, interpret=True)
    _close(y, jy2, SEQ_TOL)
    _close(yc, jyc, SEQ_TOL)
    _close(ht, jy2[:, -1], SEQ_TOL)
    _close(ct, jyc[:, -1], SEQ_TOL)
    # the two modes of the twin are one recurrence
    np.testing.assert_array_equal(y.numpy(), y_a.numpy())
    np.testing.assert_array_equal(ct.numpy(), ct_a.numpy())


def _lstm_params(seed, i, h):
    p = jrnn.init_lstm(jax.random.PRNGKey(seed), i, h)
    rng = np.random.default_rng(seed)
    p = p._replace(bias=p.bias + 0.1 * rng.standard_normal(4 * h).astype(np.float32))
    tp = trnn.LSTMParams(*(_t(a) for a in p))
    return p, tp


@pytest.mark.parametrize("n,t,h,lengths,block", [
    (4, 12, 96, [12, 7, 1, 0], None),
    (10, 9, 128, [9, 0, 3, 9, 1, 8, 2, 9, 5, 4], 4),  # 3 batch blocks in JAX
    (3, 1, 96, [1, 0, 1], None),
    (3, 7, 96, None, None),
])
def test_lstm_pack_matches_pallas(n, t, h, lengths, block, monkeypatch):
    if block is not None:
        monkeypatch.setattr(jpl, "_MAX_BLOCK_N", block)
    i = 24
    p, tp = _lstm_params(n + t, i, h)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((n, t, i)).astype(np.float32)
    h0 = (rng.standard_normal((n, h)) * 0.3).astype(np.float32)
    c0 = (rng.standard_normal((n, h)) * 0.3).astype(np.float32)
    jl = None if lengths is None else jnp.asarray(lengths)
    tl = None if lengths is None else torch.tensor(lengths)
    jy, (jh, jc) = jpl.lstm_pack_pallas(x, (h0, c0), p, jl, interpret=True)
    y, (hf, cf) = tk.lstm_pack(_t(x), (_t(h0), _t(c0)), tp, tl)
    _close(y, jy, SEQ_TOL)
    _close(hf, jh, SEQ_TOL)
    _close(cf, jc, SEQ_TOL)
    if lengths is not None:
        mask = np.arange(t)[None, :] >= np.asarray(lengths)[:, None]
        assert (y.numpy()[mask] == 0).all()
        empty = np.asarray(lengths) == 0
        np.testing.assert_array_equal(hf.numpy()[empty], h0[empty])
        np.testing.assert_array_equal(cf.numpy()[empty], c0[empty])


@pytest.mark.parametrize("mode", ["pack", "haste"])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_lstm_scan_matches_jax(mode, dtype):
    n, t, i, h = 4, 7, 12, 16
    p, tp = _lstm_params(3, i, h)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((n, t, i)).astype(np.float32)
    h0 = (rng.standard_normal((n, h)) * 0.3).astype(np.float32)
    c0 = (rng.standard_normal((n, h)) * 0.3).astype(np.float32)
    lengths = [7, 3, 0, 5]
    jd = None if dtype is None else jnp.bfloat16
    td = None if dtype is None else torch.bfloat16
    tol = 1e-5 if dtype is None else SEQ_TOL
    jy, (jh, jc) = jrnn.lstm_scan(x, (h0, c0), p, lengths=jnp.asarray(lengths),
                                  compute_dtype=jd, length_mode=mode)
    y, (hf, cf) = trnn.lstm_scan(_t(x), (_t(h0), _t(c0)), tp,
                                 lengths=torch.tensor(lengths),
                                 compute_dtype=td, length_mode=mode)
    _close(y, jy, tol)
    _close(hf, jh, tol)
    _close(cf, jc, tol)


@pytest.mark.parametrize("mode", ["pack", "haste"])
@pytest.mark.parametrize("with_lengths", [True, False])
def test_gru_scan_matches_jax(mode, with_lengths):
    n, t, i, h = 3, 6, 10, 14
    p = jrnn.init_gru(jax.random.PRNGKey(5), i, h)
    rng = np.random.default_rng(5)
    p = p._replace(
        bias=p.bias + 0.1 * rng.standard_normal(3 * h).astype(np.float32),
        recurrent_bias=p.recurrent_bias
        + 0.1 * rng.standard_normal(3 * h).astype(np.float32),
    )
    tp = trnn.GRUParams(*(_t(a) for a in p))
    x = rng.standard_normal((n, t, i)).astype(np.float32)
    h0 = (rng.standard_normal((n, h)) * 0.3).astype(np.float32)
    lengths = [6, 2, 0] if with_lengths else None
    jy, (jh,) = jrnn.gru_scan(
        x, (h0,), p, lengths=None if lengths is None else jnp.asarray(lengths),
        length_mode=mode,
    )
    y, (hf,) = trnn.gru_scan(
        _t(x), (_t(h0),), tp,
        lengths=None if lengths is None else torch.tensor(lengths),
        length_mode=mode,
    )
    _close(y, jy, 1e-5)
    _close(hf, jh, 1e-5)


def test_time_reduce_and_mish():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 5)).astype(np.float32)
    jx, jl = jrnn.time_reduce(jnp.asarray(x), jnp.asarray([9, 4]), 2)
    tx, tl = trnn.time_reduce(_t(x), torch.tensor([9, 4]), 2)
    _close(tx, jx, 1e-6)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _close(trnn.mish(_t(x)), jrnn.mish(jnp.asarray(x)), 1e-6)
