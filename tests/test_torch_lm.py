"""The port's LM (libreasr_tpu_torch.models.lm), its carry-over from the
JAX package's lm.msgpack and back, and greedy LM fusion
(models/decode.py) against the JAX package's, on the CPU.

Tolerances, beside the measured values:
- LM log-probs and (h, c): 1e-5 absolute (the same float32 products
  summed in another order by XLA's and PyTorch's CPU GEMMs; measured
  4.8e-7 at most);
- greedy fusion: tokens, lengths, the primed flags and the round counts
  exact; float leaves (predictor and LM carries, h_pred, the
  standardized LM log-probs) 1e-5 absolute (measured 5.1e-6 in the
  standardized log-probs, whose division by the standard deviation
  scales the sums' order difference up; 1.2e-7 elsewhere);
- the golden transcripts exact.
"""

import os

import numpy as np
import pytest
import torch

from helpers.tiny_decoder import TINY, assert_state_equal, build, np_variables
from libreasr_tpu_torch.api import ASRBundle
from libreasr_tpu_torch.checkpoint import load_bundle, msgpack_restore
from libreasr_tpu_torch.convert import (export_lm_variables, flatten_variables,
                                        load_jax_lm_variables)
from libreasr_tpu_torch.data.audio import read_wav
from libreasr_tpu_torch.models import decode as tdecode
from libreasr_tpu_torch.models.lm import LM, LMConfig

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
BPE = os.path.join(FIXTURES, "model_bpe.tar.gz")
TEXTS = [
    "yes", "no", "hello world", "stop now",
    "go left", "turn right", "one two", "three four",
]
LM_TOL = 1e-5
STATE_TOL = 1e-5


def _jax_lm(cfg: dict, seed: int):
    import jax

    from libreasr_tpu.models.lm import LMConfig as JaxLMConfig
    from libreasr_tpu.models.lm import init_lm

    return init_lm(JaxLMConfig(**cfg), jax.random.PRNGKey(seed))


def _check_lm(jlm, jvars, lm, vocab, hidden, layers, seed):
    """Log-probs and carried state at T 1 and T 5, from zeros and from a
    random state, id 0 (zero embedding) included."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    for t in (1, 5):
        y = rng.integers(0, vocab, (3, t))
        y[0, 0] = 0
        st = tuple((rng.standard_normal((3, hidden)).astype(np.float32),
                    rng.standard_normal((3, hidden)).astype(np.float32))
                   for _ in range(layers))
        for state in (None, st):
            jst = None if state is None else tuple(
                (jnp.asarray(h), jnp.asarray(c)) for h, c in state)
            tst = None if state is None else tuple(
                (torch.from_numpy(h), torch.from_numpy(c)) for h, c in state)
            jl, js = jlm.apply(jvars, jnp.asarray(y), state=jst)
            with torch.no_grad():
                tl, ts = lm(torch.from_numpy(y), state=tst)
            assert tl.shape == (3, t, vocab)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                       atol=LM_TOL)
            for (jh, jc), (th, tc) in zip(js, ts):
                np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                                           atol=LM_TOL)
                np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                                           atol=LM_TOL)


@pytest.mark.parametrize("embed,hidden,layers", [(16, 16, 1), (16, 16, 2),
                                                 (12, 20, 1), (12, 20, 2)],
                         ids=["tied-1", "tied-2", "untied-1", "untied-2"])
def test_lm_matches_jax(embed, hidden, layers):
    """Tied (x @ embed.T) and untied (an `out` Dense) LMs of 1 and 2
    layers, carried across with load_jax_lm_variables; the export is the
    JAX tree again, leaf for leaf."""
    cfg = dict(vocab_sz=40, embed_sz=embed, hidden_sz=hidden, num_layers=layers)
    jlm, jvars = _jax_lm(cfg, layers + embed)
    lm = LM(LMConfig(**cfg))
    assert lm.tied == (embed == hidden) and (lm.out is None) == lm.tied
    load_jax_lm_variables(lm, np_variables(jvars))
    _check_lm(jlm, jvars, lm, 40, hidden, layers, seed=layers)
    want = flatten_variables(np_variables(jvars))
    got = flatten_variables(export_lm_variables(lm))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_lm_config_defaults_equal_jax():
    from libreasr_tpu.models.lm import LMConfig as JaxLMConfig

    for conf in ({}, {"lm": {}}, {"lm": {"vocab_sz": 64, "embed_sz": 24,
                                        "hidden_sz": 24, "num_layers": 1,
                                        "p": 0.0}}):
        j = JaxLMConfig.from_config(conf)
        assert LMConfig.from_config(conf).__dict__ == j.__dict__


def test_lm_load_refuses_a_mismatched_tree():
    lm = LM(LMConfig(vocab_sz=10, embed_sz=4, hidden_sz=4, num_layers=1))
    tree = export_lm_variables(lm)
    with pytest.raises(ValueError, match="params only"):
        load_jax_lm_variables(lm, {**tree, "batch_stats": {}})
    del tree["params"]["lstm0"]["bias"]
    with pytest.raises(ValueError, match="missing"):
        load_jax_lm_variables(lm, tree)


def test_golden_bundle_lm_matches_jax(tmp_path):
    """The BPE golden bundle's lm.msgpack (1 layer, 24 wide, tied, V 64)
    through the port's loader against the JAX package's LM on it."""
    from libreasr_tpu.api import ASRBundle as JaxBundle

    tb = ASRBundle.from_bundle(BPE, extract_to=str(tmp_path / "t"), device="cpu")
    jb = JaxBundle.from_bundle(BPE, extract_to=str(tmp_path / "j"))
    assert tb.lm.cfg.__dict__ == jb.lm.cfg.__dict__ and tb.lm.tied
    _check_lm(jb.lm, jb.lm_variables, tb.lm, 64, 24, 1, seed=7)


def test_save_round_trips_the_lm(tmp_path):
    """save writes lm.msgpack with the leaves the bundle had, bit for bit
    (flax keeps a namedtuple's field order where the port sorts keys, so
    the bytes may differ and the trees are compared); the port's
    from_bundle and the JAX package's read it back equal."""
    from libreasr_tpu.api import ASRBundle as JaxBundle

    tb = ASRBundle.from_bundle(BPE, extract_to=str(tmp_path / "src"), device="cpu")
    out = tb.save(str(tmp_path / "re.tar.gz"))
    _, _, lm_src, _ = load_bundle(BPE, "en", extract_to=str(tmp_path / "a"))
    _, _, lm_out, _ = load_bundle(out, "en", extract_to=str(tmp_path / "b"))
    want = flatten_variables(msgpack_restore(lm_src))
    got = flatten_variables(msgpack_restore(lm_out))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    re = ASRBundle.from_bundle(out, extract_to=str(tmp_path / "re"), device="cpu")
    for (name, a), b in zip(tb.lm.state_dict().items(), re.lm.state_dict().values()):
        assert torch.equal(a, b), name
    jb = JaxBundle.from_bundle(out, extract_to=str(tmp_path / "j"))
    got = flatten_variables(np_variables(jb.lm_variables))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_from_config_builds_an_lm_only_with_a_path():
    """As JAX's from_config: an LM (seed + 1) only when `lm.enable` and
    `lm.path` are set."""
    from libreasr_tpu_torch.config import parse_and_apply_config

    conf = parse_and_apply_config(inference=True)
    conf["model"].update(feature_sz=80, embed_sz=8, hidden_sz=16, out_sz=16,
                         joint_sz=16, vocab_sz=20)
    conf["model"]["encoder"]["num_layers"] = 1
    conf["model"]["predictor"]["num_layers"] = 1
    conf["lm"].update(vocab_sz=20, embed_sz=8, hidden_sz=8, num_layers=1)
    assert ASRBundle.from_config(conf, device="cpu").lm is None
    conf["lm"]["path"] = "unused.msgpack"
    b = ASRBundle.from_config(conf, seed=3, device="cpu")
    assert b.lm.cfg == LMConfig(vocab_sz=20, embed_sz=8, hidden_sz=8, num_layers=1)
    again = LM(b.lm.cfg, seed=4)
    assert torch.equal(b.lm.embed.embedding, again.embed.embedding)


# ---- greedy LM fusion --------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    return build()


GREEDY_FIELDS = ("pred_state", "h_pred", "last_token", "y_buf", "y_len",
                 "lm_state", "lm_logits", "lm_primed", "sum_iters", "ones")


@pytest.mark.parametrize("early_exit", [True, False])
def test_decode_frame_with_lm_matches_jax(tiny, early_exit):
    """Six frames of decode_frame with the LM (alpha 0.5), ragged valid
    masks, every DecodeState leaf against JAX after each; both early
    exit forms of the port. The fused argmax differs from the joint's on
    some rows (checked), so the fusion decides tokens here."""
    import jax.numpy as jnp

    from libreasr_tpu.models.decode import decode_frame as jframe
    from libreasr_tpu.models.decode import init_decode_state as jinit

    _, jfns, _, tfns, j_encode, _, _ = tiny
    v, n = TINY["vocab_sz"], 4
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 6, TINY["feature_sz"])).astype(np.float32)
    enc = np.asarray(j_encode(x))
    kw = dict(blank=0, max_iters=3, fusion_alpha=0.5)
    js = jinit(jfns, n, v, bos=2, max_tokens=12)
    no_lm = tdecode.DecoderFns(predict_step=tfns.predict_step,
                               joint_step=tfns.joint_step)
    with torch.no_grad():
        ts = tdecode.init_decode_state(tfns, n, vocab_sz=v, bos=2, max_tokens=12)
        plain = tdecode.init_decode_state(no_lm, n, bos=2, max_tokens=12)
        for f in range(6):
            valid = rng.random(n) > 0.2
            js = jframe(jfns, js, jnp.asarray(enc[:, f]), jnp.asarray(valid), **kw)
            ts = tdecode.decode_frame(tfns, ts, torch.from_numpy(enc[:, f].copy()),
                                      torch.from_numpy(valid), early_exit=early_exit,
                                      **kw)
            plain = tdecode.decode_frame(no_lm, plain,
                                         torch.from_numpy(enc[:, f].copy()),
                                         torch.from_numpy(valid), **kw)
            assert_state_equal(js, ts, GREEDY_FIELDS, STATE_TOL)
    assert bool(ts.lm_primed.any())
    assert not torch.equal(ts.y_buf, plain.y_buf)


@pytest.fixture(scope="module")
def golden_audio():
    audio = np.zeros((8, 16000), np.float32)
    for i in range(8):
        audio[i] = read_wav(os.path.join(FIXTURES, f"s-{i:03d}.wav"))[0][0]
    return audio


def test_greedy_lm_fusion_exact(golden_audio, tmp_path):
    """tests/test_golden_decode.py::test_greedy_lm_fusion_exact through
    the port, and its tokens against the JAX package's transcribe_batch
    program with the LM."""
    from libreasr_tpu.api import ASRBundle as JaxBundle

    tb = ASRBundle.from_bundle(BPE, extract_to=str(tmp_path / "t"), device="cpu")
    lengths = np.full(8, 16000)
    texts, _ = tb.transcribe_batch(golden_audio, lengths, use_lm=True)
    assert texts == TEXTS
    toks, lens, metrics = tb.decode_tokens(golden_audio, lengths, use_lm=True)
    jb = JaxBundle.from_bundle(BPE, extract_to=str(tmp_path / "j"))
    jt, jl, jm = jb._decode_program(True, 3, 256)(jb.variables, jb.lm_variables,
                                                  golden_audio, lengths)
    np.testing.assert_array_equal(lens, np.asarray(jl))
    np.testing.assert_array_equal(toks, np.asarray(jt))
    np.testing.assert_allclose(metrics["alignment_score"],
                               np.asarray(jm["alignment_score"]), rtol=1e-6)
