"""The port's CTC model family (models/ctc.py, training/ctc_learner.py,
and model.name CTCModel in the training CLI) against the JAX package's.

The port's model takes the JAX model's variables (init_ctc's, carried
across with convert.load_jax_ctc_variables), so both compute on the
same weights and the same numpy inputs. Tolerances: both take the same
float32 sums in another order (XLA's einsums and LayerNorm's fast
variance against PyTorch's): log-probs 2e-5 absolute (values of a few
units), losses 1e-5 relative, gradients 1e-4 of each tensor's largest
entry. One exception, stated where it is used: the gradient of an
infeasible row (loss ~1e5) takes exp() of differences of numbers near
1e5, whose float32 spacing is 2**-7, so its entries move by ~1% of
their size between any two summation orders: 2e-2 absolute there.
Parameters after three adamw steps (lr 1e-3): 2e-5 absolute. Tokens
and lengths of the greedy decode are compared exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from libreasr_tpu.models.ctc import CTCConfig as JaxCTCConfig
from libreasr_tpu.models.ctc import ctc_decode_greedy as jax_decode
from libreasr_tpu.models.ctc import ctc_loss as jax_ctc_loss
from libreasr_tpu.models.ctc import init_ctc
from libreasr_tpu_torch.convert import (export_ctc_variables, flatten_variables,
                                        load_jax_ctc_variables)
from libreasr_tpu_torch.models.ctc import (CTCConfig, CTCModel, ctc_decode_greedy,
                                           ctc_loss)

SMALL = dict(feature_sz=16, d_model=16, n_heads=2, n_layers=2, vocab_sz=10)
LOGP_TOL = 2e-5


def _np_tree(variables):
    return serialization.to_state_dict(jax.tree_util.tree_map(np.asarray, variables))


def _pair(dropout=0.1, seed=0, **kw):
    cfg = dict(SMALL, dropout=dropout, **kw)
    jmodel, jvars = init_ctc(JaxCTCConfig(**cfg), jax.random.PRNGKey(seed))
    model = CTCModel(CTCConfig(**cfg))
    load_jax_ctc_variables(model, _np_tree(jvars))
    return jmodel, jvars, model


@pytest.mark.parametrize("feature_sz", [16, 24], ids=["no_in_proj", "in_proj"])
def test_forward_matches_jax_with_padded_rows(feature_sz):
    """Ragged lengths, a row of length 1 and a fully padded tail: every
    row and frame, padded ones included (uniform attention there)."""
    jmodel, jvars, model = _pair(feature_sz=feature_sz)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 12, feature_sz)).astype(np.float32)
    lens = np.array([12, 7, 1, 3])
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(x), jnp.asarray(lens)))
    got = model(torch.from_numpy(x), torch.from_numpy(lens))
    assert got.shape == (4, 12, 10) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=LOGP_TOL)
    want_nolen = np.asarray(jmodel.apply(jvars, jnp.asarray(x)))
    np.testing.assert_allclose(model(torch.from_numpy(x)).detach().numpy(),
                               want_nolen, rtol=0, atol=LOGP_TOL)
    assert (model.in_proj is None) == (feature_sz == 16)


def test_variables_round_trip():
    _, jvars, model = _pair(feature_sz=24)
    back = flatten_variables(export_ctc_variables(model))
    want = flatten_variables(_np_tree(jvars))
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
    with pytest.raises(ValueError):
        load_jax_ctc_variables(model, {"params": {}})


def test_train_mode_dropout():
    """Dropout 0: training mode equals eval mode. Dropout 0.5: it needs
    a generator, differs, and repeats with the same seed."""
    _, _, m0 = _pair(dropout=0.0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 9, 16)).astype(np.float32))
    lens = torch.tensor([9, 5])
    ev = m0(x, lens)
    m0.train()
    torch.testing.assert_close(m0(x, lens), ev, rtol=0, atol=0)
    _, _, m = _pair(dropout=0.5)
    ev = m(x, lens)
    m.train()
    with pytest.raises(ValueError):
        m(x, lens)
    a = m(x, lens, generator=torch.Generator().manual_seed(3))
    b = m(x, lens, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, ev)


def _loss_case():
    """Feasible, repeated-label and infeasible rows (7 alternating
    labels in 3 frames)."""
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 8, 10)).astype(np.float32)
    logp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    labels = np.array([[1, 2, 3, 0, 0, 0, 0], [4, 4, 5, 5, 0, 0, 0],
                       [1, 2, 1, 2, 1, 2, 1]], np.int32)
    return logp, labels, np.array([8, 8, 3]), np.array([3, 4, 7])


def test_loss_and_gradients_match_optax():
    logp, labels, fl, ll = _loss_case()
    args = tuple(jnp.asarray(a) for a in (labels, fl, ll))
    want = np.asarray(jax_ctc_loss(jnp.asarray(logp), *args))
    want_g = np.asarray(jax.grad(lambda z: jax_ctc_loss(z, *args).sum())(jnp.asarray(logp)))
    lp = torch.from_numpy(logp.copy()).requires_grad_()
    got = ctc_loss(lp, *(torch.from_numpy(a) for a in (labels, fl, ll)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    assert 1e5 < float(got[2].detach()) < 1.001e5  # optax's log_epsilon, not zero_infinity
    got.sum().backward()
    g = lp.grad.numpy()
    for i in range(2):
        np.testing.assert_allclose(g[i], want_g[i], rtol=0,
                                   atol=1e-4 * np.abs(want_g[i]).max())
    np.testing.assert_allclose(g[2], want_g[2], rtol=0, atol=2e-2)
    # the infeasible row is not torch's ctc_loss(zero_infinity=True)
    ref = torch.nn.functional.ctc_loss(
        torch.from_numpy(logp).transpose(0, 1), torch.from_numpy(labels).long(),
        torch.from_numpy(fl), torch.from_numpy(ll), reduction="none",
        zero_infinity=True)
    assert float(ref[2]) == 0.0
    np.testing.assert_allclose(got[:2].detach().numpy(), ref[:2].numpy(), rtol=1e-5)


def test_model_gradients_match_jax():
    jmodel, jvars, model = _pair(dropout=0.0, feature_sz=24)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 10, 24)).astype(np.float32)
    fl = np.array([10, 6, 4])
    labels = rng.integers(1, 10, (3, 4)).astype(np.int32)
    ll = np.array([4, 2, 3])

    def jloss(p):
        lp = jmodel.apply({"params": p}, jnp.asarray(x), jnp.asarray(fl))
        return jax_ctc_loss(lp, jnp.asarray(labels), jnp.asarray(fl), jnp.asarray(ll)).mean()

    want_l, want_g = jax.value_and_grad(jloss)(jvars["params"])
    model.train()
    loss = ctc_loss(model(torch.from_numpy(x), torch.from_numpy(fl)),
                    torch.from_numpy(labels), torch.from_numpy(fl),
                    torch.from_numpy(ll)).mean()
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(want_l), rtol=1e-5)
    want = flatten_variables(_np_tree({"params": want_g}))
    top = max(np.abs(w).max() for w in want.values())
    for n, g in zip(names, grads):
        w = want[f"params.{n}"]
        # the key bias's true gradient is 0 (softmax ignores a constant
        # per query), so both sides hold float32 noise there: a floor of
        # 1e-6 of the largest gradient
        np.testing.assert_allclose(g.numpy(), w, rtol=0, err_msg=n,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-2 * top))


def test_greedy_decode_matches_jax():
    rng = np.random.default_rng(4)
    logp = rng.standard_normal((5, 30, 6)).astype(np.float32)
    logp[:, ::3, 0] += 2.0  # blanks between runs
    logp[1, :, 2] += 5.0  # one long run: collapses to one token
    lens = np.array([30, 17, 1, 0, 29])
    for max_tokens in (256, 4):
        jt, jl = jax_decode(jnp.asarray(logp), jnp.asarray(lens), max_tokens=max_tokens)
        pt, pl = ctc_decode_greedy(torch.from_numpy(logp), torch.from_numpy(lens),
                                   max_tokens=max_tokens)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    # blank, A, A, blank, B, B, B -> [A, B]; A blank A -> [A, A]
    for seq, want in (([0, 1, 1, 0, 2, 2, 2], [1, 2]), ([1, 0, 1], [1, 1])):
        lp = np.full((1, len(seq), 4), -10.0, np.float32)
        lp[0, np.arange(len(seq)), seq] = 0.0
        t, n = ctc_decode_greedy(torch.from_numpy(lp), torch.tensor([len(seq)]))
        assert t[0, : int(n[0])].tolist() == want


def _frontend_pair():
    from libreasr_tpu.ops.frontend import FrontendConfig as JaxFrontend
    from libreasr_tpu_torch.ops.frontend import FrontendConfig

    off = dict(cut_max_front=0, cut_max_back=0, time_masks=0, freq_masks=0)
    return JaxFrontend(**off), FrontendConfig(**off)


@pytest.mark.parametrize("with_frontend", [False, True], ids=["features", "pcm"])
def test_learner_steps_match_jax(with_frontend):
    """Three CTCLearner steps, dropout 0, no SpecAugment, adamw with
    clipping and a schedule: loss and finite flag at every step, every
    parameter after steps 1 and 3, grad_norm at every step."""
    from libreasr_tpu.training.ctc_learner import CTCLearner as JaxLearner
    from libreasr_tpu.training.learner import Batch as JaxBatch
    from libreasr_tpu.training.optimizers import build_optimizer as jax_opt
    from libreasr_tpu.training.optimizers import make_lr_schedule as jax_sched
    from libreasr_tpu_torch.training import optimizers as topt
    from libreasr_tpu_torch.training.ctc_learner import CTCLearner
    from libreasr_tpu_torch.training.learner import Batch

    feat = 1280 if with_frontend else 16
    jmodel, jvars, model = _pair(dropout=0.0, feature_sz=feat)
    sched = {"lr": 1e-3, "total_steps": 10, "warmup_pct": 0.3}
    jfe, tfe = _frontend_pair() if with_frontend else (None, None)
    jl = JaxLearner(jmodel, jvars, jax_opt("adamw", jax_sched(sched), grad_clip=1.0),
                    frontend=jfe, seed=0)
    tl = CTCLearner(model, topt.build_optimizer("adamw", topt.make_lr_schedule(sched),
                                                grad_clip=1.0), tfe, seed=0)
    rng = np.random.default_rng(5)
    for i in range(3):
        if with_frontend:
            audio = (rng.standard_normal((3, 9600)) * 0.1).astype(np.float32)
            alen = np.array([9600, 7000, 4000])
        else:
            audio = rng.standard_normal((3, 11, 16)).astype(np.float32)
            alen = np.array([11, 8, 5])
        b = (audio, alen, rng.integers(1, 10, (3, 3)).astype(np.int32), np.array([3, 2, 1]))
        jm = jl.step(JaxBatch(*(jnp.asarray(x) for x in b)))
        tm = tl.step(Batch(*(torch.from_numpy(np.asarray(x)) for x in b)))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4)
        assert bool(tm["finite"]) and bool(jm["finite"])
        if i in (0, 2):
            want = flatten_variables(_np_tree({"params": jl.state.params}))
            got = flatten_variables(export_ctc_variables(tl.model))
            assert set(got) == set(want)
            # the key biases' true gradient is 0, so Adam turns float32
            # noise into steps of up to the learning rate, of either
            # sign: those are held within twice the sum of the step sizes
            noise = 2 * sum(topt.make_lr_schedule(sched)(t) for t in range(i + 1))
            for k in want:
                tol = noise if k.endswith("key.bias") else 2e-5
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)


def test_nan_features_step_as_jax():
    """The finite gate reads the loss, and ctc_loss maps NaN to 0 (JAX's
    nan_to_num): NaN features give a loss of 0 that counts as finite,
    and NaN gradients, in both packages."""
    from libreasr_tpu.training.ctc_learner import CTCLearner as JaxLearner
    from libreasr_tpu.training.learner import Batch as JaxBatch
    from libreasr_tpu_torch.training import optimizers as topt
    from libreasr_tpu_torch.training.ctc_learner import CTCLearner
    from libreasr_tpu_torch.training.learner import Batch

    jmodel, jvars, model = _pair(dropout=0.0)
    jl = JaxLearner(jmodel, jvars, optax.adamw(1e-3))
    tl = CTCLearner(model, topt.build_optimizer("adamw", 1e-3, grad_clip=1e9), None)
    b = (np.full((2, 6, 16), np.nan, np.float32), np.array([6, 6]),
         np.array([[1, 2], [3, 0]], np.int32), np.array([2, 1]))
    jm = jl.step(JaxBatch(*(jnp.asarray(x) for x in b)))
    tm = tl.step(Batch(*(torch.from_numpy(x) for x in b)))
    assert float(tm["loss"]) == float(jm["loss"]) == 0.0
    assert bool(tm["finite"]) and bool(jm["finite"])
    assert np.isnan(float(tm["grad_norm"])) and np.isnan(float(jm["grad_norm"]))
    assert tl.state.step == 1


def test_evaluate_scores_rows():
    """evaluate decodes greedily in eval mode, back to training after."""
    from libreasr_tpu_torch.data.language import get_language
    from libreasr_tpu_torch.training import optimizers as topt
    from libreasr_tpu_torch.training.ctc_learner import CTCLearner
    from libreasr_tpu_torch.training.learner import Batch

    _, _, model = _pair(dropout=0.3, vocab_sz=40)
    tl = CTCLearner(model, topt.build_optimizer("adamw", 1e-3), None)
    rng = np.random.default_rng(6)
    b = Batch(torch.from_numpy(rng.standard_normal((3, 8, 16)).astype(np.float32)),
              torch.tensor([8, 5, 2]), torch.tensor([[15, 16, 2], [17, 2, 0], [2, 0, 0]]),
              torch.tensor([3, 2, 1]))
    lang, _ = get_language()
    res = tl.evaluate([b, b], lang, max_batches=1)
    assert res["n"] == 3 and 0.0 <= res["cer"] and 0.0 <= res["wer"]
    assert model.training
    assert tl.evaluate([], lang) == {"wer": 1.0, "cer": 1.0, "n": 1}


def test_ctc_train_cli(tmp_path, capsys):
    """python -m libreasr_tpu_torch.train with model.name CTCModel trains
    and evaluates (the JAX package's test_ctc_train_cli, on the CPU)."""
    import wave

    import yaml

    from libreasr_tpu_torch import train as train_cli
    from libreasr_tpu_torch.data.create_dataset import create_dataset
    from libreasr_tpu_torch.data.split import split_dataset

    rng = np.random.default_rng(3)
    spk = tmp_path / "s"
    spk.mkdir()
    with open(spk / "s.trans.txt", "w") as tf:
        for i, t in enumerate(["yes", "no", "up", "down"] * 2):
            utt = f"s-{i:03d}"
            pcm = (rng.standard_normal(10000) * 0.1).clip(-1, 1)
            with wave.open(str(spk / f"{utt}.wav"), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes((pcm * 32767).astype(np.int16).tobytes())
            tf.write(f"{utt} {t.upper()}\n")
    create_dataset(str(tmp_path), "librispeech", workers=1, pool="thread")
    split_dataset(str(tmp_path), valid=0.25, test=0.0)
    conf = {
        "datasets": ["c"], "dataset_paths": {"c": str(tmp_path)},
        "apply_limits": False, "pcent": {"train": 1.0, "valid": 1.0},
        "shuffle_builder": {"train": False, "valid": False}, "sr": 16000,
        "melkwargs": {"n_fft": 1024, "n_mels": 128},
        "win_length": 0.025, "hop_length": 0.01, "deltas": 0,
        "transforms": {
            "x": [{"name": "OpenAudio"}, {"name": "ChannelCut"}, {"name": "PadderCutter"}],
            "y": [{"name": "OpenLabel"}, {"name": "Numericalize"}, {"name": "AddLen"}],
        },
        "buckets": [{"max_samples": 16000, "y_max": 8, "bs": 4}],
        "dtypes": {"compute": "float32"},
        "model": {
            "name": "CTCModel", "feature_sz": 1280, "vocab_sz": 40,
            "ctc": {"d_model": 16, "n_heads": 2, "n_layers": 1, "dropout": 0.0},
        },
        "training": {"optimizer": "adamw", "lr": 1e-3, "epochs": 1},
        "bs": 4, "accumulate_n_batches": 1, "seed": 0,
        "lm": {"enable": False}, "tokenizer": {"model_file": ""},
    }
    conf_path = tmp_path / "ctc.yaml"
    conf_path.write_text(yaml.safe_dump(conf))
    capsys.readouterr()
    train_cli.main(["--config", str(conf_path), "--steps", "2", "--device", "cpu",
                    "--ckpt", str(tmp_path / "ck"), "--eval-batches", "1",
                    "--logdir", str(tmp_path / "runs")])
    out = capsys.readouterr().out
    assert "[ctc] epoch 0 step=2" in out and "wer=" in out
    assert "[train] done: step=2" in out
    assert not os.path.exists(tmp_path / "ck")  # the CTC path saves nothing


def test_unknown_model_name_raises(tmp_path):
    import yaml

    from libreasr_tpu_torch import train as train_cli

    p = tmp_path / "x.yaml"
    p.write_text(yaml.safe_dump({"model": {"name": "Conformer"}}))
    with pytest.raises(ValueError, match="Conformer"):
        train_cli.main(["--config", str(p), "--device", "cpu"])
