"""LayerNorm-LSTM cells and the add joint in the port against the JAX
package: the scan (both length modes, ragged lengths with 0, zoneout and
DropConnect from JAX's masks), a tiny Transducer with an LN encoder and
the add joint (forward, the non-fused loss, its gradients), the
refusals JAX keeps, and decoding: greedy, beam, streaming, int8, and
bundles crossing between the packages.

Tolerances: float32 on both sides, the same sums in another order:
- the scan's outputs and states 1e-5 (measured 1.1e-6), gradients 1e-5
  of each tensor's largest entry;
- the model's lattice logits and tower outputs 1e-4 (two layers, LNs,
  a joint: measured 4.5e-7), losses 1e-5 relative, gradients 1e-4 of
  each tensor's largest entry;
- decoded tokens and lengths exactly; beam scores 1e-4 (as
  tests/test_beam.py:105); the streaming state 1e-5 (the log-mel carry
  1e-4, as tests/test_torch_streaming.py states why);
- the int8 bundles: tokens exactly (the int8 products are exact on both
  sides, tests/test_torch_quant.py).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from helpers.tiny_decoder import np_variables
from libreasr_tpu_torch.api import ASRBundle
from libreasr_tpu_torch.config import apply_overrides, open_config
from libreasr_tpu_torch.convert import export_variables, load_jax_variables
from libreasr_tpu_torch.data.language import get_language
from libreasr_tpu_torch.models.streaming import StreamingEngine
from libreasr_tpu_torch.models.transducer import Transducer, TransducerConfig
from libreasr_tpu_torch.ops import rnn as trnn
from libreasr_tpu_torch.ops.rnnt_loss import rnnt_loss
from libreasr_tpu_torch.training import optimizers as topt
from libreasr_tpu_torch.training.learner import Learner, LossConfig

SCAN_TOL = 1e-5
MODEL_TOL = 1e-4
SCORE_TOL = 1e-4
STATE_TOL = 1e-5
MEL_TOL = 1e-4
CHUNK = 1280


def _scan_setup(seed, n=3, t=14, i=6, h=10):
    import jax

    from libreasr_tpu.ops import rnn as jrnn

    rng = np.random.default_rng(seed)
    params = [np.asarray(a) for a in
              jrnn.init_layernorm_lstm(jax.random.PRNGKey(seed), i, h)]
    # move the LN leaves off ones and zeros, so that each one matters
    params = [a + 0.2 * rng.standard_normal(a.shape).astype(np.float32)
              for a in params]
    x = rng.standard_normal((n, t, i)).astype(np.float32)
    state = [(rng.standard_normal((n, h)) * 0.3).astype(np.float32)
             for _ in range(2)]
    return params, x, state


def _close(a, b, tol, msg=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=tol, err_msg=msg)


@pytest.mark.parametrize("mode", ["pack", "haste"])
def test_layernorm_lstm_scan_matches_jax(mode):
    """Eval, with ragged lengths (one 0) and without lengths."""
    import jax.numpy as jnp

    from libreasr_tpu.ops import rnn as jrnn

    params, x, state = _scan_setup(1)
    for lengths in (np.array([14, 6, 0]), None):
        jy, jst = jrnn.layernorm_lstm_scan(
            jnp.asarray(x), tuple(jnp.asarray(s) for s in state),
            jrnn.LayerNormLSTMParams(*params),
            lengths=None if lengths is None else jnp.asarray(lengths),
            length_mode=mode)
        ty, tst = trnn.layernorm_lstm_scan(
            torch.from_numpy(x), tuple(torch.from_numpy(s) for s in state),
            trnn.LayerNormLSTMParams(*(torch.from_numpy(a) for a in params)),
            lengths=None if lengths is None else torch.from_numpy(lengths),
            length_mode=mode)
        _close(ty, jy, SCAN_TOL)
        for a, b in zip(tst, jst):
            _close(a, b, SCAN_TOL)
    # the LN cell differs from the plain one on the same matrices
    plain, _ = trnn.lstm_scan(torch.from_numpy(x),
                              tuple(torch.from_numpy(s) for s in state),
                              trnn.LSTMParams(*(torch.from_numpy(a)
                                                for a in params[:3])))
    assert float((plain - ty).abs().max()) > 1e-2


@pytest.mark.parametrize("mode", ["pack", "haste"])
def test_layernorm_lstm_training_masks_match_jax(mode):
    """Training zoneout and DropConnect together, with JAX's masks fed to
    the port: outputs, final states and every gradient."""
    import jax
    import jax.numpy as jnp

    from libreasr_tpu.ops import rnn as jrnn

    params, x, state = _scan_setup(2)
    lengths = np.array([14, 9, 0])
    p_zo, p_dc = 0.2, 0.3
    rng = jax.random.PRNGKey(7)
    n, t, _ = x.shape
    h = state[0].shape[-1]
    dc_mask = np.asarray(jax.random.bernoulli(jax.random.fold_in(rng, 1),
                                              1.0 - p_dc, params[1].shape))
    zo_mask = np.asarray(jax.random.bernoulli(jax.random.fold_in(rng, 2),
                                              1.0 - p_zo, (t, n, h)))
    w = np.random.default_rng(3).standard_normal((n, t, h)).astype(np.float32)

    def jloss(p, xx, s):
        y, (hf, cf) = jrnn.layernorm_lstm_scan(
            xx, s, jrnn.LayerNormLSTMParams(*p), lengths=jnp.asarray(lengths),
            zoneout=p_zo, dropconnect=p_dc, rng=rng, training=True,
            length_mode=mode)
        return jnp.sum(y * w) + jnp.sum(hf * 0.7) + jnp.sum(cf * 0.3), (y, hf, cf)

    (jl, (jy, jh, jc)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                 has_aux=True)(
        [jnp.asarray(a) for a in params], jnp.asarray(x),
        tuple(jnp.asarray(s) for s in state))
    tp = [torch.tensor(a, requires_grad=True) for a in params]
    tx = torch.tensor(x, requires_grad=True)
    ts = tuple(torch.tensor(s, requires_grad=True) for s in state)
    ty, (th, tc) = trnn.layernorm_lstm_scan(
        tx, ts, trnn.LayerNormLSTMParams(*tp), lengths=torch.from_numpy(lengths),
        zoneout=p_zo, dropconnect=p_dc, training=True, length_mode=mode,
        dropconnect_mask=torch.from_numpy(dc_mask.copy()),
        zoneout_mask=torch.from_numpy(zo_mask.copy()))
    tl = (ty * torch.from_numpy(w)).sum() + (th * 0.7).sum() + (tc * 0.3).sum()
    tl.backward()
    for a, b in ((ty, jy), (th, jh), (tc, jc)):
        _close(a, b, SCAN_TOL)
    got = [p.grad for p in tp] + [tx.grad] + [s.grad for s in ts]
    want = list(jg[0]) + [jg[1]] + list(jg[2])
    for i, (a, b) in enumerate(zip(got, want)):
        scale = max(float(np.abs(np.asarray(b)).max()), 1e-6)
        _close(a, b, SCAN_TOL * scale, f"grad {i}")


SMALL = {
    "model": {
        "feature_sz": 24, "embed_sz": 8, "vocab_sz": 11, "hidden_sz": 16,
        "out_sz": 12, "joint_sz": 10, "joint": {"method": "add"},
        "encoder": {"rnn_type": "LSTM", "num_layers": 2, "dropout": 0.0,
                    "layer_norm": True},
        "predictor": {"rnn_type": "LSTM", "num_layers": 1, "dropout": 0.0,
                      "layer_norm": True},
    },
    "dtypes": {"compute": "float32"},
}


def _small(pred_type):
    conf = copy.deepcopy(SMALL)
    conf["model"]["predictor"]["rnn_type"] = pred_type
    return conf


def _perturbed_pair(conf, seed):
    """JAX variables with every leaf moved off its init value, and the
    port model carrying them."""
    import jax
    from flax import serialization

    from libreasr_tpu.models.transducer import Transducer as JaxTransducer
    from libreasr_tpu.models.transducer import TransducerConfig as JaxConfig
    from libreasr_tpu.models.transducer import init_transducer

    _, variables = init_transducer(JaxConfig.from_config(conf),
                                   jax.random.PRNGKey(seed))
    tree = np_variables(variables)
    rng = np.random.default_rng(seed)

    def move(path, v):
        v = np.asarray(v, np.float32) + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
        return np.abs(v) + 0.5 if path[-1].key == "var" else v

    tree = jax.tree_util.tree_map_with_path(move, tree)
    jvars = serialization.from_state_dict(variables, tree)
    tmodel = Transducer(TransducerConfig.from_config(conf))
    load_jax_variables(tmodel, tree)
    return JaxTransducer(JaxConfig.from_config(conf)), jvars, tmodel


@pytest.mark.parametrize("pred_type", ["LSTM", "NBRC"])
def test_ln_add_transducer_forward_loss_and_grads_match_jax(pred_type):
    """An LN encoder (2 layers, T 20: the scan cells on both sides, as JAX
    keeps LN towers off its kernels) and the add joint; the predictor an
    LN-LSTM, or an NBRC whose layer_norm changes nothing (as in JAX)."""
    import jax
    import jax.numpy as jnp

    from libreasr_tpu.models.transducer import Transducer as JaxTransducer
    from libreasr_tpu.ops.rnnt_loss import rnnt_loss as jax_rnnt_loss

    conf = _small(pred_type)
    jmodel, jvars, tmodel = _perturbed_pair(conf, 4)
    cell = tmodel.predictor.rnn_stack.layer0.cell
    assert cell.rnn_type == ("LN_LSTM" if pred_type == "LSTM" else "NBRC")
    assert not hasattr(tmodel.joint, "enc_proj")
    rng = np.random.default_rng(5)
    n, t, u = 3, 20, 4
    x = rng.standard_normal((n, t, 24)).astype(np.float32)
    xl = np.array([t, 13, 1], np.int32)
    y = rng.integers(1, 11, (n, u)).astype(np.int32)
    yl = np.array([u, 2, 0], np.int32)
    tx, txl = torch.from_numpy(x), torch.from_numpy(xl).long()
    ty, tyl = torch.from_numpy(y).long(), torch.from_numpy(yl).long()

    jo, _ = jmodel.apply(jvars, x, lengths=xl, method=JaxTransducer.encode)
    to, _ = tmodel.encode(tx, lengths=txl)
    _close(to, jo, MODEL_TOL)

    def jloss(params):
        logits, _ = jmodel.apply({**jvars, "params": params}, x, y, xl, yl)
        return jax_rnnt_loss(logits, jnp.asarray(y), jnp.asarray(xl),
                             jnp.asarray(yl)).mean(), logits

    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(jvars["params"])
    names = [k for k, _ in tmodel.named_parameters()]
    logits, _ = tmodel(tx, ty, txl, tyl)
    _close(logits, jlogits, MODEL_TOL)
    tl = rnnt_loss(logits, ty, txl, tyl).mean()
    grads = torch.autograd.grad(tl, list(tmodel.parameters()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    flat = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(np_variables(jg)):
        flat[".".join(p.key for p in path)] = np.asarray(leaf)
    assert set(flat) == set(names)
    for name, g in zip(names, grads):
        scale = max(float(np.abs(flat[name]).max()), 1e-6)
        _close(g, flat[name], MODEL_TOL * scale, name)


def test_refusals_kept_as_jax(tmp_path):
    """Where JAX raises, the port raises: the fused loss with the add
    joint or with Hutchinson probes, the int8 joint with add, and the
    streaming engine with delta features."""
    import jax

    from libreasr_tpu.api import ASRBundle as JaxBundle
    from libreasr_tpu.models.streaming import StreamingEngine as JaxEngine
    from libreasr_tpu.training.learner import LossConfig as JaxLossConfig
    from libreasr_tpu.training.learner import make_train_step

    conf = _small("NBRC")
    jmodel, jvars, tmodel = _perturbed_pair(conf, 1)
    tx = topt.build_optimizer("adam", 1e-3)
    with pytest.raises(ValueError, match="concat"):
        make_train_step(jmodel, None, None, JaxLossConfig(fused=True))
    with pytest.raises(ValueError, match="concat"):
        Learner(tmodel, tx, None, LossConfig(fused=True))
    concat = copy.deepcopy(conf)
    concat["model"]["joint"]["method"] = "concat"
    jc, _, tc = _perturbed_pair(concat, 1)
    with pytest.raises(ValueError, match="first-order"):
        make_train_step(jc, None, None, JaxLossConfig(fused=True), hutchinson=True)
    with pytest.raises(ValueError, match="first-order"):
        Learner(tc, tx, None, LossConfig(fused=True), hutchinson=True)

    lang, _ = get_language()
    jb = JaxBundle(conf, jmodel, jvars, lang)
    with pytest.raises(AssertionError):
        jb.decoder_fns(quantized=True)
    tb = ASRBundle(copy.deepcopy(conf), tmodel, lang, torch.device("cpu"))
    with pytest.raises(ValueError, match="concat"):
        tb.decoder_fns(quantized=True)
    with pytest.raises(ValueError, match="concat"):
        tmodel.joint.int8_step()

    dconf = _tiny_conf(deltas=1)
    jdb = JaxBundle.from_config(dconf)
    assert jdb.frontend.deltas == 1
    with pytest.raises(NotImplementedError, match="deltas"):
        JaxEngine(jdb, n_streams=1)
    tdb = ASRBundle.from_config(copy.deepcopy(dconf), device="cpu")
    assert tdb.frontend.feature_sz == 2560 == tdb.cfg.feature_sz
    with pytest.raises(NotImplementedError, match="deltas"):
        StreamingEngine(tdb, n_streams=1)
    del jax


def _tiny_conf(deltas=0, ln=True, joint="add"):
    """base.yaml's frontend and layout at tiny widths (float32, 1 layer
    each): the LN encoder and add joint by default."""
    conf = apply_overrides(open_config("config/base.yaml"), ["inference"])
    conf["deltas"] = deltas
    conf["model"].update(feature_sz=1280 * (1 + deltas), embed_sz=8,
                         hidden_sz=16, out_sz=16, joint_sz=16, vocab_sz=40)
    conf["model"]["joint"]["method"] = joint
    conf["model"]["encoder"].update(num_layers=1, layer_norm=ln)
    conf["model"]["predictor"]["num_layers"] = 1
    conf["lm"]["enable"] = False
    conf["dtypes"]["compute"] = "float32"
    return conf


@pytest.fixture(scope="module")
def ln_add():
    """(JAX bundle, port bundle) of the tiny LN + add model on the same
    random weights."""
    from libreasr_tpu.api import ASRBundle as JaxBundle

    conf = _tiny_conf()
    jb = JaxBundle.from_config(conf)
    model = Transducer(TransducerConfig.from_config(conf))
    load_jax_variables(model, np_variables(jb.variables))
    lang, _ = get_language()
    return jb, ASRBundle(copy.deepcopy(conf), model, lang, torch.device("cpu"))


def _noise(seed, shape, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _audio():
    lengths = np.array([16000, 11000, 6000])
    audio = _noise(3, (3, 16000)) * (np.arange(16000)[None] < lengths[:, None])
    return audio.astype(np.float32), lengths


def _jax_tokens(jb, audio, lengths, quantized_joint=False):
    import jax.numpy as jnp

    toks, lens, _ = jb._decode_program(False, 3, 256)(
        jb.variables, None, jnp.asarray(audio), jnp.asarray(lengths))
    return np.asarray(toks), np.asarray(lens)


def test_ln_add_bundle_greedy_and_beam_match_jax(ln_add):
    """transcribe_batch's tokens (T 12 stacked frames, the scan cells) and
    transcribe_beam's (K 3) equal JAX's; beam scores within SCORE_TOL."""
    import jax.numpy as jnp

    jb, tb = ln_add
    audio, lengths = _audio()
    jt, jl = _jax_tokens(jb, audio, lengths)
    tt, tl, _ = tb.decode_tokens(audio, lengths)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tt, jt)
    assert jl.sum() > 0
    run = jb._beam_program(False, 3, 3, 256, 0.1, 0.0)
    jbt, jbl, jbs = run(jb.variables, None, jnp.asarray(audio),
                        jnp.asarray(lengths))
    bt, bl, bs = tb.beam_tokens(audio, lengths, beam_width=3)
    np.testing.assert_array_equal(bl, np.asarray(jbl))
    np.testing.assert_array_equal(bt, np.asarray(jbt))
    np.testing.assert_allclose(bs, np.asarray(jbs), rtol=0, atol=SCORE_TOL)
    texts, scores = tb.transcribe_beam(audio, lengths, beam_width=3)
    jtexts, jscores = jb.transcribe_beam(audio, lengths, beam_width=3)
    assert texts == jtexts


def test_ln_add_engine_matches_jax_step_by_step(ln_add):
    """The streaming engine on the LN + add model: packed tokens and counts
    equal at every step, the state within STATE_TOL (mel carry MEL_TOL),
    with ragged valid masks and a mid-stream reset."""
    import jax

    from libreasr_tpu.models.streaming import StreamingEngine as JaxEngine
    from libreasr_tpu_torch.models.streaming import _leaves

    jb, tb = ln_add
    n, steps = 3, 6
    audio = _noise(1, (n, steps * CHUNK))
    je, te = JaxEngine(jb, n_streams=n), StreamingEngine(tb, n_streams=n)
    rng = np.random.default_rng(2)
    emitted = 0
    for k in range(steps):
        chunks = audio[:, None, k * CHUNK : (k + 1) * CHUNK]
        valid = rng.random(n) > 0.2
        reset = np.array([k == 3, False, False])
        jt, jl = je.step_batch(chunks, valid, reset)
        tt, tl = te.step_batch(chunks, valid, reset)
        np.testing.assert_array_equal(tl, jl, err_msg=f"step {k}")
        np.testing.assert_array_equal(tt, jt, err_msg=f"step {k}")
        _close(te.state.mel_carry, je.state.mel_carry, MEL_TOL)
        for a, b in zip(_leaves(te.state.enc_state),
                        jax.tree_util.tree_leaves(je.state.enc_state)):
            _close(a, b, STATE_TOL)
        emitted += int(tl.sum())
    assert emitted > 0


def test_int8_ln_bundle_decodes_as_jax_quantized(ln_add):
    """quantize() int8s the LN tower's kernel and recurrent_kernel (gamma,
    gamma_h, beta_h stay float32) and the int8 LN scan runs int8_matmul:
    greedy tokens equal JAX's quantized bundle's."""
    jb, tb = ln_add
    jq = copy.copy(jb)
    jq._jit_cache = {}
    jq.quantize()
    tq = ASRBundle(copy.deepcopy(tb.conf), tb.model, tb.lang, tb.device)
    tq.quantize()
    cell = tq.model.encoder.rnn_stack.layer0.cell
    assert cell.kernel.q.dtype == torch.int8 and cell.gamma.dtype == torch.float32
    assert cell.recurrent_kernel.packed is None  # no int8 kernel reads an LN cell
    audio, lengths = _audio()
    jt, jl = _jax_tokens(jq, audio, lengths)
    tt, tl, _ = tq.decode_tokens(audio, lengths)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tt, jt)
    ft, _, _ = tb.decode_tokens(audio, lengths)
    assert not np.array_equal(ft, tt)  # the int8 cells change the tokens


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_bundles_cross_between_packages(ln_add, quantized, tmp_path):
    """A port-saved LN + add bundle loads in JAX, and a JAX-saved one in
    the port; each decodes the other's tokens."""
    from libreasr_tpu.api import ASRBundle as JaxBundle

    jb, tb = ln_add
    audio, lengths = _audio()
    tb = ASRBundle(copy.deepcopy(tb.conf), tb.model, tb.lang, tb.device)
    if quantized:
        tb.quantize()
    path = tb.save(str(tmp_path / "port.tar.gz"))
    jl = JaxBundle.from_bundle(path, extract_to=str(tmp_path / "j"))
    assert jl.cfg.joint_method == "add" and jl.cfg.enc_layer_norm
    jt, jn = _jax_tokens(jl, audio, lengths)
    tt, tn, _ = tb.decode_tokens(audio, lengths)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tt, jt)
    back = jl.save(str(tmp_path / "jax.tar.gz"))
    tl = ASRBundle.from_bundle(back, extract_to=str(tmp_path / "t"), device="cpu")
    assert tl.cfg.joint_method == "add" and tl.cfg.enc_layer_norm
    assert tl.cfg.quantized_cells == quantized
    t2, n2, _ = tl.decode_tokens(audio, lengths)
    np.testing.assert_array_equal(n2, tn)
    np.testing.assert_array_equal(t2, tt)
    cell = export_variables(tl.model)["params"]["encoder"]["rnn_stack"]["layer0"]["cell"]
    assert {"gamma", "gamma_h", "beta_h"} <= set(cell)
    assert "enc_proj" not in export_variables(tl.model)["params"]["joint"]


def test_layer_norm_leaves_nbrc_and_gru_towers_as_they_are():
    """layer_norm on a GRU/NBRC tower changes nothing (JAX's _cell_type):
    the same parameters as without it."""
    for rnn_type in ("NBRC", "GRU"):
        conf = copy.deepcopy(SMALL)
        conf["model"]["encoder"]["rnn_type"] = rnn_type
        with_ln = Transducer(TransducerConfig.from_config(conf))
        conf["model"]["encoder"]["layer_norm"] = False
        without = Transducer(TransducerConfig.from_config(conf))
        assert list(with_ln.state_dict()) == list(without.state_dict())
    ln = Transducer(TransducerConfig.from_config(SMALL))
    layer = ln.encoder.rnn_stack.layer0
    assert layer.rnn_type == "LN_LSTM" and layer.n_state == 2
    x = torch.zeros(2, 20, 24)
    assert not layer.kernel_eligible(x)
    layer.train()
    assert not layer.train_kernel_eligible(x)
    assert dataclasses.replace(ln.cfg).joint_method == "add"
