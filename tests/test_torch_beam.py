"""The port's beam search (libreasr_tpu_torch.models.beam) and the beam
side of streaming (`_beam_committed_prefix`) against the JAX package's,
on the CPU, on the tiny transducer of tests/test_beam.py (V 12) with and
without a random LM carried across; and the golden bundles' beam
transcripts through the port.

Tolerances, beside the measured values:
- tokens, lengths and every integer or bool leaf: exact;
- scores: 1e-4 absolute, as tests/test_beam.py:105 holds its oracle
  (JAX and the port add the same float32 log-probs, summed in another
  order inside log_softmax and the GEMMs: measured 9.5e-7 after four
  frames, 0.0 on the decodes);
- float leaves of the state (predictor and LM carries, h_pred, the LM's
  log-probs): 1e-5 absolute (measured 2.4e-7 at most);
- `_merge_pools`, `collapse_to_best` and `_beam_committed_prefix` only
  select, so every leaf is compared exactly.

Top-k ties: jax.lax.top_k puts the lower index first among equal values;
dead beams all score exactly NEG, so the merge cases feed tied and
all-NEG pools.
"""

import os

import numpy as np
import pytest
import torch

from helpers.tiny_decoder import TINY, assert_state_equal, build, leaves
from libreasr_tpu_torch.api import ASRBundle
from libreasr_tpu_torch.data.audio import read_wav
from libreasr_tpu_torch.models import beam as tbeam
from libreasr_tpu_torch.models.decode import DecoderFns
from libreasr_tpu_torch.models.streaming import _beam_committed_prefix

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
TEXTS = [
    "yes", "no", "hello world", "stop now",
    "go left", "turn right", "one two", "three four",
]
SCORE_TOL = 1e-4
STATE_TOL = 1e-5
FIELDS = ("pred_state", "h_pred", "last_token", "scores", "y_buf", "y_len",
          "lm_state", "lm_logp")
V = TINY["vocab_sz"]


@pytest.fixture(scope="module")
def tiny():
    return build()


def _enc(j_encode, seed, n=2, t=6):
    x = np.random.default_rng(seed).standard_normal((n, t, TINY["feature_sz"]))
    enc = np.asarray(j_encode(x.astype(np.float32)))
    return enc, torch.from_numpy(enc.copy())


def _random_beam_state(rng, n, k, cap, v, h, scores, lm: bool):
    """A numpy BeamState's fields (pred carry one layer of (h,), the LM
    one layer of (h, c) when `lm`)."""
    y_len = rng.integers(0, cap + 1, (n, k))
    return dict(
        pred_state=((rng.standard_normal((n * k, h)).astype(np.float32),),),
        h_pred=rng.standard_normal((n, k, h)).astype(np.float32),
        last_token=rng.integers(0, v, (n, k)).astype(np.int32),
        scores=np.asarray(scores, np.float32),
        y_buf=(rng.integers(1, v, (n, k, cap))
               * (np.arange(cap) < y_len[:, :, None])).astype(np.int32),
        y_len=y_len.astype(np.int32),
        lm_state=(((rng.standard_normal((n * k, h)).astype(np.float32),
                    rng.standard_normal((n * k, h)).astype(np.float32)),)
                  if lm else ()),
        lm_logp=rng.standard_normal((n, k, v)).astype(np.float32),
    )


def _both(fields):
    """The same state as a JAX BeamState and a port BeamState."""
    import jax.numpy as jnp

    from libreasr_tpu.models.beam import BeamState as JaxBeamState

    def to_j(x):
        return tuple(to_j(y) for y in x) if isinstance(x, tuple) else jnp.asarray(x)

    def to_t(x):
        if isinstance(x, tuple):
            return tuple(to_t(y) for y in x)
        return torch.from_numpy(x.astype(np.int64) if x.dtype == np.int32 else x)

    return (JaxBeamState(**{k: to_j(v) for k, v in fields.items()}),
            tbeam.BeamState(**{k: to_t(v) for k, v in fields.items()}))


NEG = tbeam.NEG
# per stream a pool a and a pool b (K 4): ties inside a pool, across the
# pools, dead beams at exactly NEG, and a stream all NEG in both
MERGE_SCORES = [
    ([[0.5, 0.5, NEG, NEG], [-1.0, -2.0, -2.0, NEG], [NEG] * 4],
     [[0.5, NEG, NEG, NEG], [-2.0, -2.0, -1.0, -3.0], [NEG] * 4]),
    ([[0.0, -1.0, -1.0, -1.0], [NEG] * 4, [3.0, NEG, NEG, NEG]],
     [[-1.0, -1.0, NEG, NEG], [-5.0, NEG, NEG, NEG], [3.0, 3.0, 3.0, 3.0]]),
]


@pytest.mark.parametrize("lm", [False, True])
@pytest.mark.parametrize("case", range(len(MERGE_SCORES)))
def test_merge_pools_matches_jax_on_ties(case, lm):
    from libreasr_tpu.models.beam import _merge_pools as jmerge

    rng = np.random.default_rng(case)
    sa, sb = MERGE_SCORES[case]
    n, k = 3, 4
    ja, ta = _both(_random_beam_state(rng, n, k, 5, V, 3, sa, lm))
    jb, tb = _both(_random_beam_state(rng, n, k, 5, V, 3, sb, lm))
    assert_state_equal(jmerge(ja, jb, n, k), tbeam._merge_pools(ta, tb, n, k),
                       FIELDS, 0.0, exact=FIELDS)


@pytest.mark.parametrize("lm", [False, True])
def test_collapse_to_best_matches_jax_on_ties(lm):
    from libreasr_tpu.models.beam import collapse_to_best as jcollapse

    rng = np.random.default_rng(3)
    scores = [[-1.0, 0.5, 0.5, NEG], [NEG] * 4, [2.0, NEG, 2.0, -1.0]]
    j, t = _both(_random_beam_state(rng, 3, 4, 6, V, 3, scores, lm))
    assert_state_equal(jcollapse(j), tbeam.collapse_to_best(t), FIELDS, 0.0,
                       exact=FIELDS)


@pytest.mark.parametrize("force_margin", [0, 2])
@pytest.mark.parametrize("seed", range(3))
def test_committed_prefix_matches_jax(seed, force_margin):
    """Random pools whose beams share prefixes of random lengths, dead
    beams disagreeing, buffers up to capacity: every output equal."""
    from libreasr_tpu.models.streaming import _beam_committed_prefix as jprefix

    rng = np.random.default_rng(10 + seed)
    n, k, cap = 5, 3, 8
    scores = rng.standard_normal((n, k)).astype(np.float32)
    scores[rng.random((n, k)) < 0.3] = NEG
    scores[:, 0] = np.maximum(scores[:, 0], -0.5)  # one live beam a stream
    f = _random_beam_state(rng, n, k, cap, V, 3, scores, True)
    shared = rng.integers(0, cap + 1, n)
    for i in range(n):  # beams share a prefix of length shared[i]
        f["y_buf"][i, :, : shared[i]] = f["y_buf"][i, 0, : shared[i]]
        f["y_len"][i] = np.maximum(f["y_len"][i], shared[i])
    j, t = _both(f)
    jc, jl, jst = jprefix(j, force_margin=force_margin)
    tc, tl, tst = _beam_committed_prefix(t, force_margin=force_margin)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert_state_equal(jst, tst, FIELDS, 0.0, exact=FIELDS)


def test_committed_prefix_forced_commit_on_saturation():
    """tests/test_beam.py:180 through the port: a stream whose buffer
    nears capacity commits its best beam whole and collapses its pool;
    a stream far from full commits only the agreed prefix."""
    n, k, cap, v, h = 2, 2, 8, 5, 3
    y_buf = torch.zeros((n, k, cap), dtype=torch.long)
    y_buf[0, 0, :7] = torch.arange(1, 8)
    y_buf[0, 1, :6] = torch.arange(11, 17)
    y_buf[1, 0, :3] = torch.tensor([4, 4, 2])
    y_buf[1, 1, :2] = torch.tensor([4, 4])
    st = tbeam.BeamState(
        pred_state=(torch.arange(n * k * h, dtype=torch.float32).reshape(n * k, h),),
        h_pred=torch.ones((n, k, h)),
        last_token=torch.tensor([[7, 16], [2, 4]]),
        scores=torch.tensor([[0.0, -1.0], [-0.5, 0.0]]),
        y_buf=y_buf, y_len=torch.tensor([[7, 6], [3, 2]]),
        lm_state=(), lm_logp=torch.zeros((n, k, v)),
    )
    committed, commit_len, out = _beam_committed_prefix(st, force_margin=2)
    assert commit_len.tolist() == [7, 2]
    assert committed[0, :7].tolist() == list(range(1, 8))
    assert out.y_len[0].tolist() == [0, 0]
    assert out.scores[0, 0] == 0.0 and out.scores[0, 1] <= NEG / 2
    ps = out.pred_state[0].reshape(n, k, h)
    assert torch.equal(ps[0, 1], ps[0, 0])
    assert committed[1, :2].tolist() == [4, 4]
    assert out.y_len[1].tolist() == [1, 0]
    assert out.y_buf[1, 0, 0] == 2


@pytest.mark.parametrize("lm", [False, True])
def test_beam_frame_matches_jax(tiny, lm):
    """Four frames of beam_frame, with an invalid frame per stream, every
    leaf against JAX after each (K 3, max_expand 3; with the LM alpha
    0.3, beta 0.5)."""
    from libreasr_tpu.models.beam import beam_frame as jframe
    from libreasr_tpu.models.beam import init_beam_state as jinit

    jfns, jfns_lm, tfns, tfns_lm, j_encode, _, _ = tiny
    jf, tf = (jfns_lm, tfns_lm) if lm else (jfns, tfns)
    enc, enc_t = _enc(j_encode, 1, n=3, t=4)
    valid = np.array([[1, 1, 1], [1, 0, 1], [0, 1, 1], [1, 1, 0]], bool)
    kw = dict(blank=0, max_expand=3, lm_alpha=0.3, lm_beta=0.5)
    js = jinit(jf, 3, 3, V, bos=2, max_tokens=8)
    with torch.no_grad():
        ts = tbeam.init_beam_state(tf, 3, 3, V, bos=2, max_tokens=8)
        assert_state_equal(js, ts, FIELDS, STATE_TOL)
        for f in range(4):
            js = jframe(jf, js, enc[:, f], valid[f], **kw)
            ts = tbeam.beam_frame(tf, ts, enc_t[:, f], torch.from_numpy(valid[f]),
                                  **kw)
            assert_state_equal(js, ts, FIELDS, STATE_TOL)


@pytest.mark.parametrize("lm", [False, True])
def test_beam_decode_matches_jax(tiny, lm):
    """Ragged lengths, K 4: tokens and lengths exact, scores within
    SCORE_TOL."""
    import jax.numpy as jnp

    from libreasr_tpu.models.beam import beam_decode as jdecode

    jfns, jfns_lm, tfns, tfns_lm, j_encode, _, _ = tiny
    jf, tf = (jfns_lm, tfns_lm) if lm else (jfns, tfns)
    enc, enc_t = _enc(j_encode, 2, n=3, t=7)
    lens = np.array([7, 5, 3])
    kw = dict(vocab_sz=V, beam_width=4, blank=0, bos=2, max_expand=3,
              max_tokens=16, lm_alpha=0.3, lm_beta=1.5)
    jt, jl, js = jdecode(jf, jnp.asarray(enc), jnp.asarray(lens), **kw)
    with torch.no_grad():
        tt, tl, ts = tbeam.beam_decode(tf, enc_t, torch.from_numpy(lens), **kw)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=SCORE_TOL)
    assert int(tl.sum()) > 0


def _oracle_best(fns, enc, vocab, blank, bos, max_expand):
    """tests/test_beam.py's exhaustive frame-synchronous search on the
    port's endpoints: every per-frame emission chain of depth <=
    max_expand (blank-terminated, or forced at the maximum depth).
    Returns (best score, best tokens)."""
    h0, s0 = fns.predict_step(torch.full((1, 1), bos), None)
    frontier = [(0.0, [], h0, s0)]
    for ti in range(enc.shape[0]):
        h_enc = enc[ti : ti + 1]
        new = []
        for score, toks, h_pred, state in frontier:
            stack = [(score, toks, h_pred, state, 0)]
            while stack:
                sc, tk, hp, stt, depth = stack.pop()
                logp = torch.log_softmax(fns.joint_step(hp[:, 0, :], h_enc), -1)[0]
                new.append((sc + float(logp[blank]), tk, hp, stt))
                for v in range(vocab):
                    if v == blank:
                        continue
                    h2, s2 = fns.predict_step(torch.full((1, 1), v), stt)
                    item = (sc + float(logp[v]), tk + [v], h2, s2)
                    if depth == max_expand - 1:
                        new.append(item)  # forced exit without blank
                    else:
                        stack.append(item + (depth + 1,))
        frontier = new
    return max(frontier, key=lambda x: x[0])[:2]


def test_beam_matches_exhaustive_oracle(tiny):
    """With K >= the number of hypotheses the search is exact: the
    oracle's best score (within SCORE_TOL) and tokens."""
    _, _, tfns, _, j_encode, _, _ = tiny
    _, enc_t = _enc(j_encode, 3, n=1, t=2)
    vocab, max_expand = 4, 2

    def masked_joint(h_pred, h_enc):
        logits = tfns.joint_step(h_pred, h_enc)
        return torch.where(torch.arange(logits.shape[-1]) < vocab, logits, -1e9)

    fns = DecoderFns(predict_step=tfns.predict_step, joint_step=masked_joint)
    with torch.no_grad():
        want_score, want_toks = _oracle_best(fns, enc_t[0], vocab, 0, 2, max_expand)
        toks, lens, scores = tbeam.beam_decode(
            fns, enc_t, torch.tensor([2]), vocab_sz=V, beam_width=16,
            max_expand=max_expand, max_tokens=8)
    assert abs(float(scores[0]) - want_score) < SCORE_TOL
    assert toks[0, : int(lens[0])].tolist() == want_toks


def test_wider_beam_never_scores_worse(tiny):
    _, _, tfns, _, j_encode, _, _ = tiny
    _, enc_t = _enc(j_encode, 4, n=2, t=8)
    lens = torch.tensor([8, 8])
    with torch.no_grad():
        s1 = tbeam.beam_decode(tfns, enc_t, lens, vocab_sz=V, beam_width=1,
                               max_tokens=32)[2]
        s4 = tbeam.beam_decode(tfns, enc_t, lens, vocab_sz=V, beam_width=4,
                               max_tokens=32)[2]
    assert (s4 >= s1 - SCORE_TOL).all()


def test_lm_alpha_zero_equals_no_lm(tiny):
    """alpha 0 and beta 0: the LM's state is carried but scores nothing,
    so tokens and scores equal the decode without an LM."""
    _, _, tfns, tfns_lm, j_encode, _, _ = tiny
    _, enc_t = _enc(j_encode, 5, n=2, t=6)
    lens = torch.tensor([6, 6])
    kw = dict(vocab_sz=V, beam_width=3, max_tokens=16)
    with torch.no_grad():
        t0, l0, s0 = tbeam.beam_decode(tfns_lm, enc_t, lens, lm_alpha=0.0, **kw)
        t1, l1, s1 = tbeam.beam_decode(tfns, enc_t, lens, **kw)
        t2, _, s2 = tbeam.beam_decode(tfns_lm, enc_t, lens, lm_alpha=0.3, **kw)
    assert torch.equal(t0, t1) and torch.equal(l0, l1) and torch.equal(s0, s1)
    assert torch.isfinite(s2).all()


@pytest.mark.parametrize("lm", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_beam_frame_without_early_exit_is_identical(tiny, seed, lm):
    """All max_expand rounds masked (the streaming form) give the same
    state, every leaf bit for bit, as stopping once no beam is active.
    The blank logit is biased per seed so that frames stop after 1 to
    max_expand rounds."""
    import copy

    _, _, tfns, tfns_lm, j_encode, model, lm_mod = tiny
    model = copy.deepcopy(model)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        model.joint.out.bias[0] += float(rng.uniform(-1.0, 4.0))
    fns = DecoderFns(
        predict_step=model.predict, joint_step=model.joint_step,
        lm_step=lm_mod if lm else None,
        lm_init_state=lm_mod.init_state if lm else None)
    _, enc_t = _enc(j_encode, 20 + seed, n=4, t=5)
    max_expand = int(rng.integers(1, 5))
    with torch.no_grad():
        st = tbeam.init_beam_state(fns, 4, 3, V, bos=2, max_tokens=6)
        outs = {True: st, False: st}
        for f in range(5):
            valid = torch.from_numpy(rng.random(4) > 0.2)
            for early in (True, False):
                outs[early] = tbeam.beam_frame(fns, outs[early], enc_t[:, f],
                                               valid, max_expand=max_expand,
                                               lm_alpha=0.3, early_exit=early)
    for f in FIELDS:
        a, b = getattr(outs[True], f), getattr(outs[False], f)
        for x, y in zip(leaves(a), leaves(b)):
            assert torch.equal(x, y), f


# ---- golden, through the port --------------------------------------------


@pytest.fixture(scope="module")
def golden_audio():
    audio = np.zeros((8, 16000), np.float32)
    for i in range(8):
        audio[i] = read_wav(os.path.join(FIXTURES, f"s-{i:03d}.wav"))[0][0]
    return audio


def test_beam_exact(golden_audio, tmp_path):
    """tests/test_golden_decode.py::test_beam_exact: the char bundle,
    K 3; one [S] clip gives (text, score)."""
    bundle = ASRBundle.from_bundle(os.path.join(FIXTURES, "model.tar.gz"),
                                   extract_to=str(tmp_path), device="cpu")
    texts, scores = bundle.transcribe_beam(golden_audio, np.full(8, 16000),
                                           beam_width=3)
    assert texts == TEXTS and np.isfinite(scores).all()
    text, score = bundle.transcribe_beam(golden_audio[2], beam_width=3)
    assert text == "hello world" and score == pytest.approx(float(scores[2]),
                                                            abs=SCORE_TOL)


def test_bpe_bundle_lm_fusion_exact(golden_audio, tmp_path):
    """tests/test_golden_decode.py::test_bpe_bundle_lm_fusion_exact (K 3,
    alpha 0.2, beta 0.6) through the port, and its tokens and scores
    against the JAX package's transcribe_beam program on the same
    bundle (scores within SCORE_TOL)."""
    import jax.numpy as jnp

    from libreasr_tpu.api import ASRBundle as JaxBundle

    path = os.path.join(FIXTURES, "model_bpe.tar.gz")
    bundle = ASRBundle.from_bundle(path, extract_to=str(tmp_path / "t"),
                                   device="cpu")
    assert bundle.lm is not None
    kw = dict(beam_width=3, use_lm=True, lm_alpha=0.2, lm_beta=0.6)
    lengths = np.full(8, 16000)
    texts, scores = bundle.transcribe_beam(golden_audio, lengths, **kw)
    assert texts == TEXTS
    toks, lens, _ = bundle.beam_tokens(golden_audio, lengths, **kw)
    jb = JaxBundle.from_bundle(path, extract_to=str(tmp_path / "j"))
    run = jb._beam_program(True, 3, 3, 256, 0.2, 0.6)
    jt, jl, js = run(jb.variables, jb.lm_variables, jnp.asarray(golden_audio),
                     jnp.asarray(lengths))
    np.testing.assert_array_equal(lens, np.asarray(jl))
    np.testing.assert_array_equal(toks, np.asarray(jt))
    np.testing.assert_allclose(scores, np.asarray(js), rtol=0, atol=SCORE_TOL)
