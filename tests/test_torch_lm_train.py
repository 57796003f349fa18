"""The port's LM trainer (libreasr_tpu_torch.train_lm, the LM's training
dropout, optimizers.warmup_cosine_decay_schedule) against the JAX
package's root train_lm.py, on the CPU.

The step comparison rebuilds JAX's train_step from its modules (LM,
optax.chain(clip_by_global_norm(1.0), adamw(schedule))) at dropout 0,
starts both sides from the JAX LM's variables (carried across with
convert.load_jax_lm_variables) and feeds both the same batch_stream
batches. Tolerances: the same float32 sums in another order (XLA's and
PyTorch's CPU GEMMs and scans): losses 1e-5 relative, parameters after
the steps 2e-5 absolute (lr 1e-2 steps; Adam's normalised direction
moves by ~1e-3 relative where a moment is tiny), log-probs of the saved
LM in JAX 1e-5 absolute (as tests/test_torch_lm.py). The schedule
(float64 on the host) is held to optax's float32 values at 1e-6 of the
peak rate, a few float32 ulps of it. Dropout is checked by
its statistics: the kept share within 0.01 of 1 - p over ~30,000 draws
(three standard deviations are 0.008), and every kept value exactly
x / (1 - p).
"""

import numpy as np
import pytest
import torch

from libreasr_tpu_torch import train_lm
from libreasr_tpu_torch.convert import (export_lm_variables, flatten_variables,
                                        load_jax_lm_variables)
from libreasr_tpu_torch.models import lm as lm_mod
from libreasr_tpu_torch.models.lm import LM, LMConfig
from libreasr_tpu_torch.training.optimizers import warmup_cosine_decay_schedule

SMALL = dict(vocab_sz=37, embed_sz=16, hidden_sz=16, num_layers=2)


def _jax_pair(p=0.0, seed=0, **kw):
    import jax
    from flax import serialization

    from libreasr_tpu.models.lm import LMConfig as JaxLMConfig
    from libreasr_tpu.models.lm import init_lm

    cfg = dict(SMALL, p=p, **kw)
    jlm, jvars = init_lm(JaxLMConfig(**cfg), jax.random.PRNGKey(seed))
    lm = LM(LMConfig(**cfg))
    load_jax_lm_variables(lm, serialization.to_state_dict(
        jax.tree_util.tree_map(np.asarray, jvars)))
    return jlm, jvars, lm


def test_dropout_statistics_and_eval_unchanged(monkeypatch):
    _, _, lm = _jax_pair(p=0.3)
    y = torch.from_numpy(np.random.default_rng(0).integers(0, 37, (32, 60)))
    before, _ = lm(y)
    seen = []
    real = lm_mod.dropout

    def spy(x, rate, generator):
        out = real(x, rate, generator)
        seen.append((x.detach(), out.detach(), rate))
        return out

    monkeypatch.setattr(lm_mod, "dropout", spy)
    lm.train()
    with pytest.raises(ValueError):
        lm(y)
    seen.clear()
    gen = torch.Generator().manual_seed(5)
    a, _ = lm(y, generator=gen)
    x, out, rate = seen[-1]
    assert rate == 0.3 and x.shape == (32, 60, 16)
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    torch.testing.assert_close(out[kept], x[kept] / 0.7, rtol=0, atol=0)
    b, _ = lm(y, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, before)
    lm.eval()
    seen.clear()
    after, _ = lm(y)
    torch.testing.assert_close(after, before, rtol=0, atol=0)
    assert not seen  # eval never draws


@pytest.mark.parametrize("args", [(4e-4, 1e-2, 20, 200, 0.0), (1e-3, 1e-3, 1, 7, 0.0),
                                  (1e-4, 5e-4, 30, 100, 5e-6)])
def test_schedule_matches_optax(args):
    import optax

    init, peak, warmup, decay, end = args
    ref = optax.warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
    ours = warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
    for step in range(decay + 5):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=0,
                                   atol=1e-6 * peak)
    with pytest.raises(ValueError):
        warmup_cosine_decay_schedule(init, peak, 10, 10)


def _corpus_ids():
    from libreasr_tpu_torch.data.language import get_language

    lang, _ = get_language()
    lines = ["the cat sat on the mat", "a dog ran far away", "hello world again"]
    ids = []
    for i in range(40):
        ids.extend(lang.numericalize(lines[i % 3], sos=True))
    return np.asarray(ids, np.int32)


def test_corpus_ids_and_stream_match_jax(tmp_path):
    import importlib
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent.parent))
    root_train_lm = importlib.import_module("train_lm")
    from libreasr_tpu.data.language import get_language as jax_language
    from libreasr_tpu_torch.data.language import get_language

    corpus = tmp_path / "c.txt"
    corpus.write_text("The cat sat.\nHello, world!\n\n it's done \n")
    jlang, _ = jax_language()
    want = []
    for line in open(corpus):
        want.extend(jlang.numericalize(line.strip(), sos=True))
    np.testing.assert_array_equal(train_lm.corpus_ids(str(corpus), get_language()[0]),
                                  np.asarray(want, np.int32))
    ids = _corpus_ids()
    a, b = train_lm.batch_stream(ids, 4, 8, seed=1), root_train_lm.batch_stream(ids, 4, 8, seed=1)
    for _ in range(3):
        for x, y in zip(next(a), next(b)):
            np.testing.assert_array_equal(x, y)


def test_steps_match_jax_train_step():
    """Four steps at dropout 0 on the same batch_stream batches: the loss
    of every step, and every parameter after the second and fourth."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax import serialization

    jlm, jvars, lm = _jax_pair(p=0.0)
    lr, steps = 1e-2, 4
    schedule = optax.warmup_cosine_decay_schedule(lr / 25, lr, max(steps // 10, 1), steps)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(schedule))
    params = jvars["params"]
    opt_state = tx.init(params)

    def loss_fn(params, x, y):
        logp, _ = jlm.apply({"params": params}, x, train=True,
                            rngs={"dropout": jax.random.PRNGKey(0)})
        return -jnp.take_along_axis(logp, y[..., None], axis=-1)[..., 0].mean()

    @jax.jit
    def train_step(params, opt_state, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, y)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    trainer = train_lm.LMTrainer(lm, train_lm.lm_optimizer(lr, steps))
    stream = train_lm.batch_stream(_corpus_ids(), 6, 12)
    for step in range(1, steps + 1):
        x, y = next(stream)
        params, opt_state, jloss = train_step(params, opt_state, jnp.asarray(x), jnp.asarray(y))
        loss = trainer.step(x, y)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        if step % 2 == 0:
            want = flatten_variables(serialization.to_state_dict(
                jax.tree_util.tree_map(np.asarray, {"params": params})))
            got = flatten_variables(export_lm_variables(lm))
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-5, err_msg=k)
    assert trainer.state.step == steps and lm.training


def test_saved_lm_loads_in_jax_and_in_the_port(tmp_path):
    import jax.numpy as jnp
    from flax import serialization

    from libreasr_tpu_torch.checkpoint import msgpack_restore

    jlm, jvars, lm = _jax_pair(p=0.3, seed=1)
    trainer = train_lm.LMTrainer(lm, train_lm.lm_optimizer(1e-2, 3))
    stream = train_lm.batch_stream(_corpus_ids(), 4, 10)
    for _ in range(2):
        trainer.step(*next(stream))
    path = train_lm.save_lm(str(tmp_path / "lm.msgpack"), lm)
    raw = open(path, "rb").read()
    restored = serialization.from_bytes(jvars, raw)
    lm.eval()
    y = np.random.default_rng(2).integers(0, 37, (3, 9))
    want, _ = jlm.apply(restored, jnp.asarray(y))
    got, _ = lm(torch.from_numpy(y))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    back = LM(LMConfig(**SMALL, p=0.3))
    load_jax_lm_variables(back, msgpack_restore(raw))
    torch.testing.assert_close(back(torch.from_numpy(y))[0], got, rtol=0, atol=0)


def test_lm_trainer_cli(tmp_path, capsys):
    """The port's CLI (mirrors the JAX package's test_lm_trainer_smoke)."""
    corpus = tmp_path / "c.txt"
    corpus.write_text("the cat sat on the mat\n" * 200)
    out = tmp_path / "lm.msgpack"
    res = train_lm.main([
        "--corpus", str(corpus), "--bs", "8", "--seq-len", "16",
        "--steps", "30", "--eval-every", "15",
        "--embed-sz", "16", "--hidden-sz", "16", "--num-layers", "1",
        "--out", str(out), "--device", "cpu",
    ])
    assert out.exists()
    printed = capsys.readouterr().out
    assert "ppl=" in printed and "[lm] step 30 " in printed
    assert "[lm] vocab=" in printed and "[lm] saved -> " in printed
    assert len(res["valid_losses"]) == 2
    assert res["valid_losses"][1] < res["valid_losses"][0]
