"""The port's int8 ops against the JAX package's on the same inputs.

- `quantize` and `int8_matmul` equal `libreasr_tpu.ops.quant` bit for
  bit: both round half to even, divide in IEEE float32 and sum the
  int8 products exactly (int32 in JAX, float64 in the port).
- `quantize_rnn_cells` picks the same leaves.
- The int8 kernel's twin and `lstm_pack` against the Pallas kernel C
  run in interpret mode, and the int8 scan cells against ops/rnn.py.
  Both sides compute the same int8 products; they differ only in
  sigmoid/tanh, by an ulp of float32, which can flip one element of
  the next step's quantized h: atol 1e-4, the JAX package's own
  tolerance between its kernel and its scan (tests/test_pallas_lstm.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from libreasr_tpu.models.transducer import TransducerConfig, init_transducer
from libreasr_tpu.ops import quant as jq
from libreasr_tpu.ops import rnn as jrnn
from libreasr_tpu.ops.pallas import lstm as jpl
from libreasr_tpu_torch.config import apply_overrides, open_config
from libreasr_tpu_torch.convert import flatten_variables
from libreasr_tpu_torch.ops import quant as tq
from libreasr_tpu_torch.ops import rnn as trnn
from libreasr_tpu_torch.ops.kernels import lstm as tk

TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


@pytest.mark.parametrize("shape", [(96, 40), (1280, 64), (3, 5, 7), (9,)])
def test_quantize_matches_jax(shape):
    rng = np.random.default_rng(len(shape) * 10 + shape[-1])
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero column: scale 1e-12, q 0
    if len(shape) > 1:
        w[..., 1] = np.round(w[..., 1] * 4) / 4  # exact .5 quotients
    want = jq.quantize(jnp.asarray(w))
    got = tq.quantize(_t(w))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(tq.dequantize(got).numpy(),
                                  np.asarray(jq.dequantize(want)))


def test_int8_matmul_matches_jax_bit_for_bit():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 7, 96)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row: scale 1e-12
    w = rng.standard_normal((96, 40)).astype(np.float32)
    want = jq.int8_matmul(jnp.asarray(x), jq.quantize(jnp.asarray(w)))
    got = tq.int8_matmul(_t(x), tq.quantize(_t(w)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_matmul_k1280_at_127_is_exact():
    """K 1280 with every product at ±127²: the sums reach 127²·1280 ≈
    2.06e7 > 2**24, where a float32 running sum is no longer exact."""
    rng = np.random.default_rng(4)
    k = 1280
    x = rng.choice([-1.0, 1.0], (6, k)).astype(np.float32)
    x[0] = 1.0
    q = rng.choice([-127, 127], (k, 16)).astype(np.int8)
    q[:, 0] = 127
    scale = (rng.random((1, 16)) * 0.01 + 1e-3).astype(np.float32)
    want = np.asarray(jq.int8_matmul(
        jnp.asarray(x), jq.QuantizedTensor(jnp.asarray(q), jnp.asarray(scale))))
    got = tq.int8_matmul(_t(x), tq.QuantizedTensor(_t(q), _t(scale))).numpy()
    np.testing.assert_array_equal(got, want)
    # row 0, column 0 sums 1280 products of 127 * 127: a float32 running
    # sum drifts off the exact value
    products = np.full(k, 127.0 * 127.0, np.float32)
    assert np.cumsum(products, dtype=np.float32)[-1] != 127 * 127 * k


def test_quantize_rnn_cells_selects_jax_leaves():
    conf = apply_overrides(open_config(), ["inference"])
    conf["model"].update(feature_sz=24, embed_sz=8, vocab_sz=11, hidden_sz=16,
                         out_sz=12, joint_sz=10)
    conf["model"]["encoder"]["num_layers"] = 2
    conf["model"]["predictor"]["num_layers"] = 2
    _, variables = init_transducer(TransducerConfig.from_config(conf),
                                   jax.random.PRNGKey(0))
    want = flatten_variables(serialization.to_state_dict(
        jax.tree_util.tree_map(np.asarray, jq.quantize_rnn_cells(variables))))
    plain = serialization.to_state_dict(jax.tree_util.tree_map(np.asarray, variables))
    got = flatten_variables(tq.quantize_rnn_cells(plain))
    assert sorted(got) == sorted(want)
    assert sum(k.endswith(".q") for k in got) == 8  # 4 layers x 2 matrices
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    now, full = tq.quantized_bytes(tq.quantize_rnn_cells(plain))
    jnow, jfull = jq.quantized_bytes(jq.quantize_rnn_cells(variables))
    assert (now, full) == (jnow, jfull)


@pytest.mark.parametrize("k", [96, 98, 5])
def test_pack_k4_layout(k):
    rng = np.random.default_rng(k)
    q = _t(rng.integers(-127, 128, (k, 12)).astype(np.int8))
    packed = tk.pack_k4(q)
    assert packed.dtype == torch.int32 and packed.shape == ((k + 3) // 4, 12)
    assert packed.is_contiguous()
    b = packed.numpy().view(np.int8).reshape(packed.shape[0], 12, 4)
    back = b.transpose(0, 2, 1).reshape(-1, 12)
    np.testing.assert_array_equal(back[:k], q.numpy())
    assert (back[k:] == 0).all()


def _seq_inputs(seed, n, t, h):
    rng = np.random.default_rng(seed)
    wx = rng.standard_normal((n, t, 4 * h)).astype(np.float32)
    r = (rng.standard_normal((h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    h0 = (rng.standard_normal((n, h)) * 0.5).astype(np.float32)
    c0 = (rng.standard_normal((n, h)) * 0.5).astype(np.float32)
    return wx, r, h0, c0


@pytest.mark.parametrize("n,t,h", [(3, 20, 96), (5, 17, 100), (2, 1, 96)])
def test_int8_twin_matches_pallas_kernel_c(n, t, h):
    wx, r, h0, c0 = _seq_inputs(n * 100 + t, n, t, h)
    jr = jq.quantize(jnp.asarray(r))
    jy, jyc = jpl._lstm_seq_pallas_int8(wx, jr.q, jr.scale, h0, c0,
                                        interpret=True)
    tr = tq.quantize(_t(r))
    y, yc = tk.lstm_seq_int8(_t(wx), tr.q, tr.scale, _t(h0), _t(c0))
    _close(y, jy)
    _close(yc, jyc)


def _lstm_params(seed, i, h, quantize_kernel):
    p = jrnn.init_lstm(jax.random.PRNGKey(seed), i, h)
    rng = np.random.default_rng(seed)
    p = p._replace(bias=p.bias + 0.1 * rng.standard_normal(4 * h).astype(np.float32))
    jp = jrnn.LSTMParams(
        jq.quantize(p.kernel) if quantize_kernel else p.kernel,
        jq.quantize(p.recurrent_kernel), p.bias)
    tp = trnn.LSTMParams(
        tq.quantize(_t(p.kernel)) if quantize_kernel else _t(p.kernel),
        tq.quantize(_t(p.recurrent_kernel)), _t(p.bias))
    return jp, tp


@pytest.mark.parametrize("n,t,h,lengths,quantize_kernel", [
    (4, 20, 96, [20, 7, 1, 0], True),
    (3, 17, 100, [0, 17, 9], True),
    (3, 12, 96, None, True),
    (2, 8, 96, None, False),  # only R quantized
    (3, 9, 100, [9, 0, 4], False),
])
def test_int8_lstm_pack_matches_pallas(n, t, h, lengths, quantize_kernel):
    i = 24
    jp, tp = _lstm_params(n + t, i, h, quantize_kernel)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((n, t, i)).astype(np.float32)
    h0 = (rng.standard_normal((n, h)) * 0.3).astype(np.float32)
    c0 = (rng.standard_normal((n, h)) * 0.3).astype(np.float32)
    jl = None if lengths is None else jnp.asarray(lengths)
    tl = None if lengths is None else torch.tensor(lengths)
    jy, (jh, jc) = jpl.lstm_pack_pallas(x, (h0, c0), jp, jl, interpret=True)
    y, (hf, cf) = tk.lstm_pack(_t(x), (_t(h0), _t(c0)), tp, tl)
    _close(y, jy)
    _close(hf, jh)
    _close(cf, jc)
    if lengths is not None:
        mask = np.arange(t)[None, :] >= np.asarray(lengths)[:, None]
        assert (y.numpy()[mask] == 0).all()
        empty = np.asarray(lengths) == 0
        np.testing.assert_array_equal(hf.numpy()[empty], h0[empty])
        np.testing.assert_array_equal(cf.numpy()[empty], c0[empty])


@pytest.mark.parametrize("mode", ["pack", "haste"])
def test_int8_lstm_scan_matches_jax(mode):
    n, t, i, h = 4, 7, 12, 16
    jp, tp = _lstm_params(3, i, h, True)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((n, t, i)).astype(np.float32)
    h0 = (rng.standard_normal((n, h)) * 0.3).astype(np.float32)
    c0 = (rng.standard_normal((n, h)) * 0.3).astype(np.float32)
    lengths = [7, 3, 0, 5]
    # compute_dtype is ignored by int8 products on both sides
    jy, (jh, jc) = jrnn.lstm_scan(x, (h0, c0), jp, lengths=jnp.asarray(lengths),
                                  compute_dtype=jnp.bfloat16, length_mode=mode)
    y, (hf, cf) = trnn.lstm_scan(_t(x), (_t(h0), _t(c0)), tp,
                                 lengths=torch.tensor(lengths),
                                 compute_dtype=torch.bfloat16, length_mode=mode)
    _close(y, jy)
    _close(hf, jh)
    _close(cf, jc)


@pytest.mark.parametrize("mode", ["pack", "haste"])
def test_int8_gru_scan_matches_jax(mode):
    n, t, i, h = 3, 6, 10, 14
    p = jrnn.init_gru(jax.random.PRNGKey(5), i, h)
    rng = np.random.default_rng(5)
    p = p._replace(
        bias=p.bias + 0.1 * rng.standard_normal(3 * h).astype(np.float32),
        recurrent_bias=p.recurrent_bias
        + 0.1 * rng.standard_normal(3 * h).astype(np.float32),
    )
    jp = p._replace(kernel=jq.quantize(p.kernel),
                    recurrent_kernel=jq.quantize(p.recurrent_kernel))
    tp = trnn.GRUParams(tq.quantize(_t(p.kernel)),
                        tq.quantize(_t(p.recurrent_kernel)),
                        _t(p.bias), _t(p.recurrent_bias))
    x = rng.standard_normal((n, t, i)).astype(np.float32)
    h0 = (rng.standard_normal((n, h)) * 0.3).astype(np.float32)
    lengths = [6, 2, 0]
    jy, (jh,) = jrnn.gru_scan(x, (h0,), jp, lengths=jnp.asarray(lengths),
                              length_mode=mode)
    y, (hf,) = trnn.gru_scan(_t(x), (_t(h0),), tp, lengths=torch.tensor(lengths),
                             length_mode=mode)
    _close(y, jy)
    _close(hf, jh)
