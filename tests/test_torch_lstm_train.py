"""Kernels D and E (ops/kernels/lstm_train.py) against the JAX package.

The port's training recurrence (LSTMTrainCore on the twins of kernels D
and E, here on the CPU) and its pack wrapper `lstm_pack_train` against
JAX's `lstm_pack_train_pallas` in interpret mode and against `jax.grad`
through the JAX scan, on the same inputs made with numpy.

Tolerances. float32 R: the two sides take the same float32 sums in
another order (the recurrent product, and dR as one [H, N*T] x [N*T, 4H]
product on both sides but blocked differently): losses within 1e-5
relative, every gradient within 1e-5 of its tensor's largest entry
(measured: 4e-7). bf16 R: both round h before D's product, dv before
E's, and dR and the bf16 projection's gradients to bf16 at the same
places, so the float32 sums differ in order only; a sum that lands near
a bf16 rounding boundary can flip one element of the rounded gradient
by one bf16 ulp (2**-8 relative), so gradients are held at 4e-3 of
their largest entry (measured: 2e-7). Against the scan (float32 R), the
scan's per-step dR adds against the kernel route's one product:
rtol 1e-4, 1e-5 of the largest entry. The `cuda`-marked tests hold the
kernels against their twins on the card (tolerances as in
chip_smoke.py's TRAIN_*).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libreasr_tpu.ops import rnn as jrnn
from libreasr_tpu.ops.pallas import lstm as jlstm
from libreasr_tpu_torch.convert import flatten_variables, load_jax_variables
from libreasr_tpu_torch.ops import rnn as trnn
from libreasr_tpu_torch.ops.kernels import lstm_train as klt

POLICIES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}
GRAD_TOL = {"f32": 1e-5, "bf16": 4e-3}


def _inputs(seed, n=3, t=20, i=8, h=16):
    rng = np.random.default_rng(seed)
    p = jrnn.init_lstm(jax.random.PRNGKey(seed), i, h)
    params = [np.asarray(a) for a in p]
    x = rng.standard_normal((n, t, i)).astype(np.float32)
    h0 = (rng.standard_normal((n, h)) * 0.1).astype(np.float32)
    c0 = (rng.standard_normal((n, h)) * 0.1).astype(np.float32)
    w = np.cos(np.arange(n * t * h, dtype=np.float32)).reshape(n, t, h)
    return params, x, h0, c0, w


def _jax_grads(fn, params, x, h0, c0, w):
    """Loss sum(y * w) + sum(h_f * c_f) and its gradients for (kernel,
    recurrent_kernel, bias, x, h0, c0)."""

    def go(p, x, h0, c0):
        y, (hf, cf) = fn(jrnn.LSTMParams(*p), x, h0, c0)
        return jnp.sum(y * w) + jnp.sum(hf * cf)

    v, g = jax.value_and_grad(go, argnums=(0, 1, 2, 3))(
        tuple(jnp.asarray(a) for a in params), *(jnp.asarray(a) for a in (x, h0, c0)))
    return float(v), [np.asarray(a) for a in (*g[0], g[1], g[2], g[3])]


def _port_grads(fn, params, x, h0, c0, w):
    leaves = [torch.tensor(a, requires_grad=True) for a in (*params, x, h0, c0)]
    y, (hf, cf) = fn(trnn.LSTMParams(*leaves[:3]), *leaves[3:])
    loss = (y * torch.from_numpy(w)).sum() + (hf * cf).sum()
    loss.backward()
    return float(loss.detach()), [a.grad.numpy() for a in leaves]


def _close(got, want, rel, what):
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        scale = max(float(np.abs(b).max()), 1e-6)
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale,
                                   err_msg=f"{what}: gradient {k}")


@pytest.mark.parametrize("policy", ["f32", "bf16"])
def test_pack_train_matches_jax_interpret(policy):
    """Ragged lengths with a zero-length row: loss and the gradients of
    the kernel, R, bias, x, h0 and c0 equal JAX's Pallas path."""
    jcd, tcd = POLICIES[policy]
    params, x, h0, c0, w = _inputs(1)
    lengths = np.array([20, 9, 0])
    v_j, g_j = _jax_grads(lambda p, x, h0, c0: jlstm.lstm_pack_train_pallas(
        x, (h0, c0), p, jnp.asarray(lengths), compute_dtype=jcd,
        interpret=True), params, x, h0, c0, w)
    v_t, g_t = _port_grads(lambda p, x, h0, c0: klt.lstm_pack_train(
        x, (h0, c0), p, torch.from_numpy(lengths), compute_dtype=tcd),
        params, x, h0, c0, w)
    np.testing.assert_allclose(v_t, v_j, rtol=1e-5)
    _close(g_t, g_j, GRAD_TOL[policy], policy)
    # the zero-length row returns h0 and c0, whose gradient is h_f * c_f's
    assert np.abs(g_t[4][2]).max() > 0 and np.abs(g_t[5][2]).max() > 0


def test_pack_train_matches_jax_scan_gradients():
    """float32 R: the kernel route against jax.grad through the JAX scan,
    which freezes the state past each length inside the recurrence."""
    params, x, h0, c0, w = _inputs(2)
    lengths = np.array([20, 13, 0])
    v_j, g_j = _jax_grads(lambda p, x, h0, c0: jrnn.lstm_scan(
        x, (h0, c0), p, lengths=jnp.asarray(lengths)), params, x, h0, c0, w)
    v_t, g_t = _port_grads(lambda p, x, h0, c0: klt.lstm_pack_train(
        x, (h0, c0), p, torch.from_numpy(lengths)), params, x, h0, c0, w)
    np.testing.assert_allclose(v_t, v_j, rtol=1e-4)
    _close(g_t, g_j, 1e-5, "scan")


@pytest.mark.parametrize("policy", ["f32", "bf16"])
def test_core_matches_jax_core(policy):
    """LSTMTrainCore against lstm_train_core with cotangents on both
    outputs (y and the cell sequence), and with c_seq unused (its
    cotangent is materialised as zeros)."""
    jcd, tcd = POLICIES[policy]
    rng = np.random.default_rng(3)
    n, t, h = 4, 17, 24
    wx = rng.standard_normal((n, t, 4 * h)).astype(np.float32)
    r = (rng.standard_normal((h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    h0, c0 = (rng.standard_normal((2, n, h)) * 0.5).astype(np.float32)
    wy, wc = rng.standard_normal((2, n, t, h)).astype(np.float32)
    for use_c in (True, False):
        def jloss(wx, r, h0, c0):
            y, c = jlstm.lstm_train_core(wx, r if jcd is None else r.astype(jcd),
                                         h0, c0, True)
            return jnp.sum(y * wy) + (jnp.sum(c * wc) if use_c else 0.0)

        v_j, g_j = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3))(
            *(jnp.asarray(a) for a in (wx, r, h0, c0)))
        leaves = [torch.tensor(a, requires_grad=True) for a in (wx, r, h0, c0)]
        rr = leaves[1] if tcd is None else leaves[1].to(tcd)
        y, c = klt.LSTMTrainCore.apply(leaves[0], rr, leaves[2], leaves[3])
        loss = (y * torch.from_numpy(wy)).sum()
        if use_c:
            loss = loss + (c * torch.from_numpy(wc)).sum()
        loss.backward()
        # the loss sums ~2,600 terms of order 1 that largely cancel: held
        # at 1e-4 absolute, 1e-7 of the sum of their magnitudes each
        np.testing.assert_allclose(float(loss.detach()), float(v_j), rtol=0,
                                   atol=1e-4)
        _close([a.grad.numpy() for a in leaves], [np.asarray(a) for a in g_j],
               GRAD_TOL[policy], f"{policy} use_c={use_c}")


def test_batch_blocked_matches_jax_blocked(monkeypatch):
    """N = 10, off the kernels' 8-row batch tile: the port against JAX's
    Pallas path with its batch blocks shrunk to 4 (forward) and 3
    (backward), two of them padded."""
    monkeypatch.setattr(jlstm, "_MAX_BLOCK_N_TRAIN", 4)
    monkeypatch.setattr(jlstm, "_MAX_BLOCK_N_TRAIN_BWD", 3)
    params, x, h0, c0, w = _inputs(4, n=10, t=16, i=8, h=8)
    v_j, g_j = _jax_grads(lambda p, x, h0, c0: jlstm.lstm_pack_train_pallas(
        x, (h0, c0), p, None, interpret=True), params, x, h0, c0, w)
    v_t, g_t = _port_grads(lambda p, x, h0, c0: klt.lstm_pack_train(
        x, (h0, c0), p, None), params, x, h0, c0, w)
    np.testing.assert_allclose(v_t, v_j, rtol=1e-5)
    _close(g_t, g_j, 1e-5, "blocked")


def test_dropconnect_with_jax_mask():
    """DropConnect on the kernel route: R masked outside the core with
    the mask jax.random draws (fold_in(rng, 1), as JAX's RNNLayer draws
    it), fed to the port explicitly; gradients reach the unmasked R."""
    p_drop = 0.3
    params, x, h0, c0, w = _inputs(5)
    lengths = np.array([20, 16, 5])
    key = jax.random.fold_in(jax.random.PRNGKey(9), 1)
    keep = np.asarray(jax.random.bernoulli(key, 1.0 - p_drop, params[1].shape))

    def jfn(p, x, h0, c0):
        p = p._replace(recurrent_kernel=jrnn._drop_connect(
            p.recurrent_kernel, key, p_drop))
        return jlstm.lstm_pack_train_pallas(x, (h0, c0), p, jnp.asarray(lengths),
                                            compute_dtype=jnp.bfloat16,
                                            interpret=True)

    def tfn(p, x, h0, c0):
        p = p._replace(recurrent_kernel=trnn.drop_connect(
            p.recurrent_kernel, p_drop, mask=torch.from_numpy(keep.copy())))
        return klt.lstm_pack_train(x, (h0, c0), p, torch.from_numpy(lengths),
                                   compute_dtype=torch.bfloat16)

    v_j, g_j = _jax_grads(jfn, params, x, h0, c0, w)
    v_t, g_t = _port_grads(tfn, params, x, h0, c0, w)
    np.testing.assert_allclose(v_t, v_j, rtol=1e-5)
    _close(g_t, g_j, GRAD_TOL["bf16"], "dropconnect")
    assert np.all(g_t[1][~keep] == 0) and np.abs(g_t[1][keep]).max() > 0


def test_train_encoder_integration_forced(monkeypatch):
    """The port's Encoder in training with use_train_kernel (kernels D
    and E, twins on the CPU) against the JAX Encoder with
    use_pallas_train under LIBREASR_FORCE_PALLAS=1 (its kernels in
    interpret mode), from the same variables: every gradient of
    sum(y**2), and the batch statistics."""
    from flax import serialization

    from libreasr_tpu.models.modules import Encoder as JaxEncoder
    from libreasr_tpu_torch.models.modules import Encoder

    monkeypatch.setenv("LIBREASR_FORCE_PALLAS", "1")
    rng = np.random.default_rng(6)
    n, t, f, h = 2, 20, 12, 8
    x = rng.standard_normal((n, t, f)).astype(np.float32)
    lengths = np.array([20, 11])
    jenc = JaxEncoder(feature_sz=f, hidden_sz=h, out_sz=h, num_layers=2,
                      dropout=0.0, rnn_type="LSTM", use_pallas_train=True)
    jvars = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x),
                      lengths=jnp.asarray(lengths))

    def jloss(v):
        (y, _), new = jenc.apply(v, jnp.asarray(x), lengths=jnp.asarray(lengths),
                                 train=True, rngs={"dropout": jax.random.PRNGKey(1)},
                                 mutable=["batch_stats"])
        return jnp.sum(y ** 2), new

    (_, jstats), jg = jax.value_and_grad(jloss, has_aux=True)(jvars)
    tree = serialization.to_state_dict(jax.tree_util.tree_map(np.asarray, jvars))
    enc = Encoder(f, h, h, torch.Generator().manual_seed(0), num_layers=2,
                  dropout=0.0, use_train_kernel=True)
    load_jax_variables(enc, tree)
    y, _ = enc.train()(torch.from_numpy(x), lengths=torch.from_numpy(lengths))
    (y ** 2).sum().backward()
    assert type(enc.rnn_stack.layer(0).cell).__name__ == "Cell"
    want = flatten_variables(serialization.to_state_dict(
        jax.tree_util.tree_map(np.asarray, jg))["params"])
    got = {k: p.grad.numpy() for k, p in enc.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-6)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5 * scale,
                                   err_msg=k)
    stats = flatten_variables(serialization.to_state_dict(
        jax.tree_util.tree_map(np.asarray, jstats))["batch_stats"])
    buffers = dict(enc.named_buffers())
    for k in stats:
        np.testing.assert_allclose(buffers[k].numpy(), stats[k], rtol=0,
                                   atol=1e-6, err_msg=k)


def test_wrappers_refuse_other_devices():
    x = torch.empty((2, 3, 16), device="meta")
    r = torch.empty((4, 16), device="meta")
    h = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError, match="lstm_train_fwd: unsupported device"):
        klt.lstm_train_fwd(x, r, h, h)
    s = torch.empty((2, 3, 4), device="meta")
    with pytest.raises(ValueError, match="lstm_train_bwd: unsupported device"):
        klt.lstm_train_bwd(s, s, x, s, s, r)


@pytest.mark.cuda
@pytest.mark.parametrize("r_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,t,h", [(3, 37, 96), (13, 20, 100), (16, 24, 1024)])
def test_train_kernels_match_twins_on_cuda(n, t, h, r_dtype):
    """D and E against their twins, one cooperative launch each;
    tolerances as in chip_smoke.py (TRAIN_FWD_TOL, TRAIN_BWD_TOL:
    summation order, and the bf16 rounding flips of h and dv it can
    cause)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    if r_dtype == "float32" and h > 768:
        pytest.skip("float32 R of this width is above the kernels' budget")
    rng = np.random.default_rng(n + t + h)

    def rnd(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale,
                            dtype=torch.float32).cuda()

    wx, h0, c0 = rnd(n, t, 4 * h), rnd(n, h, scale=0.5), rnd(n, h, scale=0.5)
    r = rnd(h, 4 * h, scale=h ** -0.5).to(getattr(torch, r_dtype))
    before = dict(klt.LAUNCHES)
    got = klt.lstm_train_fwd(wx, r, h0, c0)
    want = klt.lstm_train_fwd_reference(wx, r, h0, c0)
    y, c_seq, v = want
    dy, dc = rnd(n, t, h, scale=0.1), rnd(n, t, h, scale=0.1)
    cprev = torch.cat([c0[:, None], c_seq[:, :-1]], 1)
    got_b = klt.lstm_train_bwd(dy, dc, v, c_seq, cprev, r)
    want_b = klt.lstm_train_bwd_reference(dy, dc, v, c_seq, cprev, r)
    torch.cuda.synchronize()
    assert klt.LAUNCHES["lstm_train_fwd"] == before["lstm_train_fwd"] + 1
    assert klt.LAUNCHES["lstm_train_bwd"] == before["lstm_train_bwd"] + 1
    for a, b in zip(got, want):
        d = (a - b).abs()
        assert float(d.max()) <= 4e-3 and float(d.mean()) <= 2e-4
    for a, b in zip(got_b, want_b):
        assert float((a - b).abs().max()) <= 4e-3 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,r_dtype", [(16, 1024, "bfloat16"), (4, 64, "float32"),
                                         (3, 96, "bfloat16")])
def test_bwd_kernel_one_step_on_cuda(n, h, r_dtype):
    """E at T 1: no carried product, only dh0 = r(dv_0) @ R^T after the
    step, in the same single launch; twice on the same inputs, the same
    bits (tolerance as above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.default_rng(n + h)

    def rnd(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale,
                            dtype=torch.float32).cuda()

    wx, h0, c0 = rnd(n, 1, 4 * h), rnd(n, h, scale=0.5), rnd(n, h, scale=0.5)
    r = rnd(h, 4 * h, scale=h ** -0.5).to(getattr(torch, r_dtype))
    _, c_seq, v = klt.lstm_train_fwd_reference(wx, r, h0, c0)
    dy, dc = rnd(n, 1, h, scale=0.1), rnd(n, 1, h, scale=0.1)
    args = (dy, dc, v, c_seq, c0[:, None].contiguous(), r)
    before = klt.LAUNCHES["lstm_train_bwd"]
    got = klt.lstm_train_bwd(*args)
    again = klt.lstm_train_bwd(*args)
    want = klt.lstm_train_bwd_reference(*args)
    torch.cuda.synchronize()
    assert klt.LAUNCHES["lstm_train_bwd"] == before + 2
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, c)
        assert float((a - b).abs().max()) <= 4e-3 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("r_dtype", ["bfloat16", "float32"])
def test_bwd_kernel_over_batch_slices_on_cuda(r_dtype):
    """E at N 300, H 1024, above one launch's (row, unit) owners: one
    cooperative launch per slice that bwd_plan takes, against the twin
    (tolerance as above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from libreasr_tpu_torch.ops.kernels import build

    n, t, h = 300, 6, 1024
    rng = np.random.default_rng(n + t + h)

    def rnd(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale,
                            dtype=torch.float32).cuda()

    wx, h0, c0 = rnd(n, t, 4 * h), rnd(n, h, scale=0.5), rnd(n, h, scale=0.5)
    r = rnd(h, 4 * h, scale=h ** -0.5).to(getattr(torch, r_dtype))
    _, c_seq, v = klt.lstm_train_fwd_reference(wx, r, h0, c0)
    dy, dc = rnd(n, t, h, scale=0.1), rnd(n, t, h, scale=0.1)
    cprev = torch.cat([c0[:, None], c_seq[:, :-1]], 1).contiguous()
    slices = klt.batch_slices(n, klt.bwd_plan, h, r.element_size(),
                              build.sm_count(0))
    assert len(slices) == 2
    before = klt.LAUNCHES["lstm_train_bwd"]
    got = klt.lstm_train_bwd(dy, dc, v, c_seq, cprev, r)
    want = klt.lstm_train_bwd_reference(dy, dc, v, c_seq, cprev, r)
    torch.cuda.synchronize()
    assert klt.LAUNCHES["lstm_train_bwd"] == before + len(slices)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 4e-3 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("r_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n,t,h", [(600, 5, 1024), (16, 1, 1024), (8, 6, 2048)])
def test_fwd_kernel_over_batch_slices_on_cuda(n, t, h, r_dtype):
    """D at N 600 (two slices of the epilogue's owners), at T 1 (no step
    barrier) and at H 2048 (R's slice read from L2): one cooperative
    launch per slice that fwd_plan takes, against the twin (TRAIN_FWD_TOL,
    as above), and a rerun on the same inputs gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from libreasr_tpu_torch.ops.kernels import build

    rng = np.random.default_rng(n + t + h)

    def rnd(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale,
                            dtype=torch.float32).cuda()

    wx, h0, c0 = rnd(n, t, 4 * h), rnd(n, h, scale=0.5), rnd(n, h, scale=0.5)
    r = rnd(h, 4 * h, scale=h ** -0.5).to(getattr(torch, r_dtype))
    slices = klt.batch_slices(n, klt.fwd_plan, h, build.sm_count(0),
                              r.element_size())
    assert len(slices) == (2 if n == 600 else 1)
    before = klt.LAUNCHES["lstm_train_fwd"]
    got = klt.lstm_train_fwd(wx, r, h0, c0)
    assert klt.LAUNCHES["lstm_train_fwd"] == before + len(slices)
    again = klt.lstm_train_fwd(wx, r, h0, c0)
    want = klt.lstm_train_fwd_reference(wx, r, h0, c0)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, c)
        d = (a - b).abs()
        assert float(d.max()) <= 4e-3 and float(d.mean()) <= 2e-4
