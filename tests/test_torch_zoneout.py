"""Zoneout and DropConnect in the port's scan cells, and the recurrent
layers' routing with them, against the JAX package.

The JAX scans draw their masks with jax.random (DropConnect from
fold_in(rng, 1), zoneout from fold_in(rng, 2)); the port draws from a
torch.Generator, so the training tests hand the port the masks JAX
draws. Tolerances: float32 everywhere, the same sums in another order:
outputs within 1e-6, gradients within 1e-5 of their largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from libreasr_tpu.models.transducer import TransducerConfig as JaxConfig
from libreasr_tpu.models.transducer import init_transducer
from libreasr_tpu.ops import rnn as jrnn
from libreasr_tpu_torch.convert import load_jax_variables
from libreasr_tpu_torch.models import modules
from libreasr_tpu_torch.models.transducer import Transducer, TransducerConfig
from libreasr_tpu_torch.ops import rnn as trnn
from libreasr_tpu_torch.ops.kernels import lstm as klstm

CELLS = {
    "lstm": (jrnn.lstm_scan, jrnn.init_lstm, trnn.lstm_scan, trnn.LSTMParams, 2),
    "gru": (jrnn.gru_scan, jrnn.init_gru, trnn.gru_scan, trnn.GRUParams, 1),
}
JAX_PARAMS = {"lstm": jrnn.LSTMParams, "gru": jrnn.GRUParams}


def _setup(cell, seed, n=3, t=18, i=6, h=10):
    jscan, init, tscan, tparams, n_state = CELLS[cell]
    rng = np.random.default_rng(seed)
    params = [np.asarray(a) for a in init(jax.random.PRNGKey(seed), i, h)]
    x = rng.standard_normal((n, t, i)).astype(np.float32)
    state = [(rng.standard_normal((n, h)) * 0.3).astype(np.float32)
             for _ in range(n_state)]
    return jscan, tscan, tparams, params, x, state


@pytest.mark.parametrize("mode", ["pack", "haste"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_eval_zoneout_matches_jax(cell, mode):
    """Eval zoneout h' = p h + (1 - p) h_new, with ragged lengths."""
    jscan, tscan, tparams, params, x, state = _setup(cell, 1)
    lengths = np.array([18, 11, 0])
    jy, jst = jscan(jnp.asarray(x), tuple(jnp.asarray(s) for s in state),
                    JAX_PARAMS[cell](*params), lengths=jnp.asarray(lengths),
                    zoneout=0.25, training=False, length_mode=mode)
    ty, tst = tscan(torch.from_numpy(x), tuple(torch.from_numpy(s) for s in state),
                    tparams(*(torch.from_numpy(a) for a in params)),
                    lengths=torch.from_numpy(lengths), zoneout=0.25,
                    training=False, length_mode=mode)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-6)
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    plain, _ = tscan(torch.from_numpy(x), tuple(torch.from_numpy(s) for s in state),
                     tparams(*(torch.from_numpy(a) for a in params)),
                     lengths=torch.from_numpy(lengths), length_mode=mode)
    assert float((plain - ty).abs().max()) > 1e-3  # zoneout changed it


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_training_masks_match_jax(cell):
    """Training zoneout and DropConnect together, with the masks JAX
    draws fed to the port: outputs, final state, and every gradient."""
    jscan, tscan, tparams, params, x, state = _setup(cell, 2)
    lengths = np.array([18, 7, 12])
    p_zo, p_dc = 0.2, 0.3
    rng = jax.random.PRNGKey(5)
    n, t, _ = x.shape
    h = state[0].shape[-1]
    dc_mask = np.asarray(jax.random.bernoulli(jax.random.fold_in(rng, 1),
                                              1.0 - p_dc, params[1].shape))
    zo_mask = np.asarray(jax.random.bernoulli(jax.random.fold_in(rng, 2),
                                              1.0 - p_zo, (t, n, h)))
    jp_type = JAX_PARAMS[cell]
    w = np.sin(np.arange(n * t * h, dtype=np.float32)).reshape(n, t, h)

    def jloss(p, x, st):
        y, fin = jscan(x, st, jp_type(*p), lengths=jnp.asarray(lengths),
                       zoneout=p_zo, dropconnect=p_dc, rng=rng, training=True)
        return jnp.sum(y * w) + sum(jnp.sum(s ** 2) for s in fin)

    v_j, g_j = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        tuple(jnp.asarray(a) for a in params), jnp.asarray(x),
        tuple(jnp.asarray(s) for s in state))
    leaves = [torch.tensor(a, requires_grad=True) for a in params]
    tx = torch.tensor(x, requires_grad=True)
    tst = tuple(torch.tensor(s, requires_grad=True) for s in state)
    y, fin = tscan(tx, tst, tparams(*leaves), lengths=torch.from_numpy(lengths),
                   zoneout=p_zo, dropconnect=p_dc, training=True,
                   dropconnect_mask=torch.from_numpy(dc_mask.copy()),
                   zoneout_mask=torch.from_numpy(zo_mask.copy()))
    loss = (y * torch.from_numpy(w)).sum() + sum((s ** 2).sum() for s in fin)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(v_j), rtol=1e-5)
    got = [a.grad.numpy() for a in (*leaves, tx, *tst)]
    want = [np.asarray(a) for a in (*g_j[0], g_j[1], *g_j[2])]
    for k, (a, b) in enumerate(zip(got, want)):
        scale = max(float(np.abs(b).max()), 1e-6)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale, err_msg=str(k))


def test_masks_drawn_from_the_generator():
    """Without explicit masks the scan draws them from its generator: the
    same seed gives the same output, another seed another one, and a
    training call without a generator raises."""
    _, tscan, tparams, params, x, state = _setup("lstm", 3)
    args = (torch.from_numpy(x), tuple(torch.from_numpy(s) for s in state),
            tparams(*(torch.from_numpy(a) for a in params)))
    kw = dict(zoneout=0.2, dropconnect=0.3, training=True)
    a, _ = tscan(*args, generator=torch.Generator().manual_seed(1), **kw)
    b, _ = tscan(*args, generator=torch.Generator().manual_seed(1), **kw)
    c, _ = tscan(*args, generator=torch.Generator().manual_seed(2), **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        tscan(*args, **kw)
    keep = trnn.drop_connect(torch.ones(200, 200), 0.25,
                             torch.Generator().manual_seed(0)) != 0
    assert abs(float(keep.float().mean()) - 0.75) < 0.01


def test_eval_zoneout_never_runs_the_eval_kernels(monkeypatch):
    """JAX's _pallas_eligible excludes zoneout: an eval LSTM layer with
    zoneout takes the scan (eval zoneout), one without takes kernel B."""
    def boom(*a, **k):
        raise AssertionError("eval kernel called")

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 20, 6), generator=gen)
    lengths = torch.tensor([20, 17])
    with_zo = modules.RNNLayer(6, 8, gen, use_kernel=True, zoneout=0.1).eval()
    assert not with_zo.kernel_eligible(x)
    monkeypatch.setattr(klstm, "lstm_seq", boom)
    y, _ = with_zo(x, lengths=lengths)
    params = with_zo.cell.params()
    want, _ = trnn.lstm_scan(x, with_zo.initial_state(2), params, lengths=lengths,
                             zoneout=0.1, training=False)
    assert torch.equal(y, want)
    without = modules.RNNLayer(6, 8, gen, use_kernel=True).eval()
    with pytest.raises(AssertionError, match="eval kernel called"):
        without(x, lengths=lengths)


def test_training_zoneout_warns_once_and_takes_the_scan(monkeypatch, capsys):
    """Zoneout in training keeps an LSTM layer off kernels D and E (the
    JAX package's rule) and says so once; DropConnect alone stays on them,
    its R masked from the generator outside the core."""
    monkeypatch.setattr(modules, "_WARNED", set())
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 20, 6), generator=gen)
    layer = modules.RNNLayer(6, 8, gen, use_train_kernel=True,
                             zoneout=0.1).train()
    for _ in range(2):
        y, _ = layer(x, generator=torch.Generator().manual_seed(1))
        assert type(y.grad_fn).__name__ != "LSTMTrainCoreBackward"
    assert capsys.readouterr().err.count("zoneout=0.1") == 1
    dc = modules.RNNLayer(6, 8, gen, use_train_kernel=True,
                          dropconnect=0.3).train()
    y, _ = dc(x, generator=torch.Generator().manual_seed(4))
    assert type(y.grad_fn).__name__ == "LSTMTrainCoreBackward"
    p = dc.cell.params()
    r = trnn.drop_connect(p.recurrent_kernel, 0.3, torch.Generator().manual_seed(4))
    want, _ = trnn.lstm_scan(x, dc.initial_state(2), p._replace(recurrent_kernel=r))
    np.testing.assert_allclose(y.detach().numpy(), want.detach().numpy(),
                               rtol=0, atol=1e-6)
    assert capsys.readouterr().err == ""


def test_transducer_eval_with_zoneout_matches_jax():
    """zoneout and dropconnect in the config reach both towers; in eval
    the lattice logits equal JAX's (eval zoneout in encoder and
    predictor, DropConnect off)."""
    conf = {"model": {
        "feature_sz": 12, "embed_sz": 6, "vocab_sz": 11, "hidden_sz": 10,
        "out_sz": 8, "joint_sz": 9, "joint": {"method": "concat"},
        "zoneout": 0.15, "dropconnect": 0.2,
        "encoder": {"rnn_type": "LSTM", "num_layers": 2, "dropout": 0.0},
        "predictor": {"rnn_type": "NBRC", "num_layers": 1, "dropout": 0.0},
    }}
    jcfg = JaxConfig.from_config(conf)
    jmodel, jvars = init_transducer(jcfg, jax.random.PRNGKey(0))
    cfg = TransducerConfig.from_config(conf)
    assert (cfg.zoneout, cfg.dropconnect) == (0.15, 0.2)
    model = Transducer(cfg)
    for tower in (model.encoder, model.predictor):
        layer = tower.rnn_stack.layer(0)
        assert (layer.zoneout, layer.dropconnect) == (0.15, 0.2)
    load_jax_variables(model, serialization.to_state_dict(
        jax.tree_util.tree_map(np.asarray, jvars)))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 20, 12)).astype(np.float32)
    y = rng.integers(1, 11, (2, 4)).astype(np.int32)
    xl, yl = np.array([20, 13]), np.array([4, 2])
    jlog, _ = jmodel.apply(jvars, *(jnp.asarray(a) for a in (x, y, xl, yl)))
    with torch.no_grad():
        tlog, _ = model(torch.from_numpy(x), torch.from_numpy(y).long(),
                        torch.from_numpy(xl), torch.from_numpy(yl))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=1e-5)
