"""The port's training CLI (python -m libreasr_tpu_torch.train) on the CPU:
a tiny transducer on a noise-WAV corpus trains with its encoder on
kernels D and E (their twins here), evaluates, checkpoints, resumes to
the step asked, and exports a bundle that the JAX package loads."""

import contextlib
import copy
import io
import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml
from helpers.noise_corpus import make_noise_corpus, tiny_conf

from libreasr_tpu.models.transducer import TransducerConfig as JaxConfig
from libreasr_tpu.models.transducer import init_transducer
from libreasr_tpu.training.checkpoint import load_bundle as jax_load_bundle
from libreasr_tpu_torch import train as cli
from libreasr_tpu_torch.api import ASRBundle
from libreasr_tpu_torch.ops.kernels import lstm_train as klt
from libreasr_tpu_torch.training.callbacks import TrainLogger
from libreasr_tpu_torch.training.checkpoint import (
    STATE_FILE, restore_params_only, restore_train_state, save_train_state,
)
from libreasr_tpu_torch.training.learner import Batch, Learner


@pytest.fixture(scope="module")
def conf_path(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    conf = tiny_conf(make_noise_corpus(root), str(root / "no-tokenizer"))
    path = root / "conf.yaml"
    path.write_text(yaml.safe_dump(conf))
    return str(path)


@pytest.fixture(scope="module")
def trained(conf_path, tmp_path_factory):
    """3 steps with a bundle export, then a resume to step 5; the kernel
    route's forward calls counted across both."""
    d = tmp_path_factory.mktemp("run")
    calls = []
    real = klt.lstm_train_fwd

    def counting(*a):
        calls.append(a[0].shape)
        return real(*a)

    mp = pytest.MonkeyPatch()
    mp.setattr(klt, "lstm_train_fwd", counting)
    common = ["--config", conf_path, "--ckpt", str(d / "ckpt"),
              "--eval-batches", "1", "--device", "cpu"]
    outs = []
    try:
        for extra in (["--steps", "3", "--bundle-out", str(d / "b.tar.gz"),
                       "--logdir", str(d / "runs")],
                      ["--steps", "5", "--logdir", str(d / "runs2")]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(common + extra)
            outs.append(buf.getvalue())
    finally:
        mp.undo()
    return d, outs, calls


def test_cli_trains_evaluates_and_resumes(trained):
    d, (first, second), calls = trained
    assert "[eval]" in first and "wer=" in first
    assert "done: step=3" in first
    assert os.path.exists(d / "ckpt" / STATE_FILE)
    assert os.path.exists(d / "b.tar.gz")
    assert "resumed" in second and "at step 3" in second
    assert "done: step=5" in second
    # every train step's encoder layer went through the kernel route (5
    # steps; the evals decode in eval mode, never through it)
    assert len(calls) == 5 and all(s[1] >= 16 for s in calls)
    log = [json.loads(line) for line in open(d / "runs" / "train_log.jsonl")]
    assert any(r["kind"] == "eval" for r in log)


def test_exported_bundle_loads_in_jax_and_transcribes(trained, conf_path, tmp_path):
    d, _, _ = trained
    conf = yaml.safe_load(open(conf_path))
    _, template = init_transducer(JaxConfig.from_config(conf), jax.random.PRNGKey(0))
    variables, _, _, conf2 = jax_load_bundle(str(d / "b.tar.gz"), "en", template,
                                             extract_to=str(tmp_path / "x"))
    bundle = ASRBundle.from_bundle(str(d / "b.tar.gz"), extract_to=str(tmp_path / "y"),
                                   device="cpu")
    for name in ("joint.out.kernel", "encoder.rnn_stack.layer0.h0"):
        node = variables["params"]
        for part in name.split("."):
            node = node[part]
        np.testing.assert_array_equal(bundle.model.state_dict()[name].numpy(),
                                      np.asarray(node))
    assert conf2["model"]["hidden_sz"] == 12
    pcm = np.random.default_rng(0).standard_normal(24000).astype(np.float32) * 0.1
    text, _ = bundle.transcribe(pcm)
    assert isinstance(text, str)


def _batch(seed, n=4, s=32000, u=6, v=37):
    rng = np.random.default_rng(seed)
    return Batch(torch.from_numpy((rng.standard_normal((n, s)) * 0.1).astype(np.float32)),
                 torch.tensor([s, s - 3000, s - 9000, s - 20000]),
                 torch.from_numpy(rng.integers(1, v, (n, u)).astype(np.int32)),
                 torch.tensor([u, u - 1, 3, 2]))


def test_restored_learner_continues_the_run(conf_path, tmp_path):
    """Two steps, save, restore into a fresh Learner: the third step (its
    carry draw, SpecAugment and dropout draws, optimizer moments) is the
    one the uninterrupted Learner takes, bit for bit."""
    conf = yaml.safe_load(open(conf_path))
    conf["model"]["encoder"]["dropout"] = 0.1
    conf["transforms"]["features"].insert(
        1, {"name": "MaskTime", "args": {"num_masks": 2, "size": 2}})
    a = Learner.from_config(copy.deepcopy(conf), device="cpu")
    for i in range(2):
        a.step(_batch(i))
    save_train_state(str(tmp_path / "ck"), a)
    b = Learner.from_config(copy.deepcopy(conf), device="cpu", seed=99)
    assert restore_train_state(str(tmp_path / "ck"), b) == 2
    la, lb = a.step(_batch(2))["loss"], b.step(_batch(2))["loss"]
    assert float(la) == float(lb)
    for p, q in zip(a.model.state_dict().values(), b.model.state_dict().values()):
        assert torch.equal(p, q)
    fresh = Learner.from_config(copy.deepcopy(conf), device="cpu", seed=5).model
    assert restore_params_only(str(tmp_path / "ck"), fresh) == 2


def test_unported_flags_and_missing_cuda_raise(conf_path, monkeypatch):
    """Every flag of the JAX CLI parses (the multi-device ones run in
    tests/test_torch_pp_train.py and on the card); an unknown --platform
    raises, and so do, without a card, the default device and --platform
    gpu."""
    args = cli.parse_args(["--mesh-model", "2", "--pp", "2", "--pp-micro", "2",
                           "--dist-coordinator", "h:1", "--dist-procs", "2",
                           "--dist-pid", "1"])
    assert (args.mesh_model, args.pp, args.pp_micro, args.dist_coordinator,
            args.dist_procs, args.dist_pid) == (2, 2, 2, "h:1", 2, 1)
    assert not hasattr(cli, "_UNPORTED")
    with pytest.raises(ValueError, match="--platform 'tpu'"):
        cli.main(["--config", conf_path, "--platform", "tpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--platform", "gpu"], ["--device", "cpu", "--platform", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--config", conf_path, *extra])


def _run(args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(args)
    return buf.getvalue()


def test_chain_steps_leave_the_parameters_of_single_steps(conf_path, tmp_path):
    """--chain-steps 2 with --steps 3 (the corpus gives 3 batches an
    epoch of one shape): one chain of 2, the third batch waits for a
    partner, and the next epoch's first cuts the chunk at --steps, so it
    steps singly. The checkpoint equals the one of 3 single steps, bit
    for bit (the same steps on the same batches, generators included).
    --platform cpu stands in for --device cpu."""
    chained_calls = []
    real = Learner.step_chained

    def counting(self, batches):
        chained_calls.append(len(batches))
        return real(self, batches)

    mp = pytest.MonkeyPatch()
    mp.setattr(Learner, "step_chained", counting)
    try:
        out = _run(["--config", conf_path, "--platform", "cpu", "--steps", "3",
                    "--chain-steps", "2", "--ckpt", str(tmp_path / "a"),
                    "--eval-batches", "1", "--logdir", str(tmp_path / "ra")])
    finally:
        mp.undo()
    _run(["--config", conf_path, "--device", "cpu", "--steps", "3",
          "--ckpt", str(tmp_path / "b"), "--eval-batches", "1",
          "--logdir", str(tmp_path / "rb")])
    assert chained_calls == [2] and "done: step=3" in out
    a = torch.load(tmp_path / "a" / STATE_FILE, weights_only=True)
    b = torch.load(tmp_path / "b" / STATE_FILE, weights_only=True)
    assert a["step"] == b["step"] == 3
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k


class _ChainLog:
    """A learner and a logger for cli._train_loop that record what ran."""

    def __init__(self):
        self.ran = []

    def step(self, b):
        self.ran.append(("single", b.tag))
        return {"loss": 0.0}

    def step_chained(self, batches):
        self.ran.append(("chain", tuple(b.tag for b in batches)))
        return {"loss": 0.0}

    def log_step(self, step, metrics, batch, prev_step=None):
        pass


def _shaped(tag, t):
    import types

    return types.SimpleNamespace(tag=tag, audio=np.zeros((2, t)),
                                 labels=np.zeros((2, 3)))


@pytest.mark.parametrize("steps,epoch,want", [
    # --steps 5: A2 fills A's chain and B2 B's; A3 waits, and the next
    # epoch's A1 fills the chain, which --steps cuts to A3 alone
    (5, ["A1", "B1", "A2", "B2", "A3"],
     [("chain", ("A1", "A2")), ("chain", ("B1", "B2")), ("single", "A3")]),
    # one epoch, no --steps: B1 never finds a partner and steps singly
    (0, ["A1", "B1", "A2"], [("chain", ("A1", "A2")), ("single", "B1")]),
], ids=["cut_at_steps", "remainder"])
def test_chain_steps_buffer_batches_by_shape(tmp_path, steps, epoch, want):
    """--chain-steps 2 over batches of two bucket shapes (A: T 8, B: T 16):
    each shape buffers on its own, a chain runs when its shape has 2, in
    arrival order within the shape."""
    import argparse

    batches = [_shaped(tag, 8 if tag[0] == "A" else 16) for tag in epoch]
    rec = _ChainLog()
    args = argparse.Namespace(steps=steps, eval_every=1000, chain_steps=2,
                              ckpt_every_s=1e9, ckpt=str(tmp_path / "ck"))
    with contextlib.redirect_stdout(io.StringIO()):
        last = cli._train_loop(args, {"training": {"epochs": 1}}, rec, batches,
                               rec, 0, lambda step: None)
    assert rec.ran == want
    assert last == sum(len(x[1]) if x[0] == "chain" else 1 for x in want)


@pytest.mark.parametrize("optimizer,plateau", [("adahessian", False),
                                               ("adam", True)],
                         ids=["adahessian", "reduce_on_plateau"])
def test_adahessian_and_plateau_configs_train(conf_path, tmp_path, optimizer,
                                              plateau):
    """An adahessian config (the lattice loss and the scan cells, as JAX's
    Hutchinson step needs) and a reduce_on_plateau config each train 2
    steps, checkpoint and export; the plateau state has seen both
    losses."""
    conf = yaml.safe_load(open(conf_path))
    conf["training"].update(optimizer=optimizer, reduce_on_plateau=plateau)
    if optimizer == "adahessian":
        conf["loss"]["fused"] = False
        conf["model"]["encoder"]["use_pallas_train"] = False
    path = tmp_path / "conf.yaml"
    path.write_text(yaml.safe_dump(conf))
    out = _run(["--config", str(path), "--device", "cpu", "--steps", "2",
                "--ckpt", str(tmp_path / "ck"), "--eval-batches", "1",
                "--bundle-out", str(tmp_path / "b.tar.gz"),
                "--logdir", str(tmp_path / "runs")])
    assert "done: step=2" in out and os.path.exists(tmp_path / "b.tar.gz")
    state = torch.load(tmp_path / "ck" / STATE_FILE, weights_only=True)
    opt = state["opt_state"]
    if plateau:
        assert opt[2]["count"] == 2 and torch.isfinite(opt[2]["avg_value"])
    else:
        assert opt[1]["count"] == 2
        assert all(torch.isfinite(v).all() for v in opt[1]["nu"])


def test_best_wer_bar_survives_resume(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    with open(ckpt + "_best_wer.json", "w") as f:
        json.dump({"wer": 0.055, "cer": 0.03, "step": 12000}, f)
    logger = TrainLogger(str(tmp_path / "runs"))
    cli._restore_best_wer_bar(logger, ckpt, start_step=0)
    assert logger.best_wer == float("inf")
    cli._restore_best_wer_bar(logger, ckpt, start_step=14000)
    assert logger.best_wer == pytest.approx(0.055)

    class _R:
        wer, cer, alignment_score, n, samples = 0.074, 0.05, 0.75, 82, []

    assert logger.log_eval(14000, _R()) is False
    _R.wer = 0.051
    assert logger.log_eval(14500, _R()) is True


def test_cli_trains_the_bpe_tokenizer_as_jax(conf_path, tmp_path, capsys):
    """train_tokenizer: the CLI dumps the training labels and trains the
    config's BPE model first (the same bytes as the JAX package's builder
    writes), then trains on its ids."""
    from libreasr_tpu.data.builder import ASRDatasetBuilder as JaxBuilder
    from libreasr_tpu_torch.data.bpe import BPELanguage
    from libreasr_tpu_torch.data.builder import ASRDatasetBuilder

    with open(conf_path) as f:
        conf = yaml.safe_load(f)
    tok = str(tmp_path / "tok" / "bpe.model")
    conf.update(train_tokenizer=True, wanted_vocab_sz=48,
                tokenizer={"model_file": tok})
    path = tmp_path / "conf.yaml"
    path.write_text(yaml.safe_dump(conf))
    cli.main(["--config", str(path), "--steps", "1", "--device", "cpu",
              "--ckpt", str(tmp_path / "ckpt"), "--logdir", str(tmp_path / "runs"),
              "--eval-batches", "1"])
    assert "[train] done: step=1" in capsys.readouterr().out
    ref = str(tmp_path / "jax.model")
    JaxBuilder.from_config(conf, "train").train_tokenizer(ref, 48)
    with open(tok, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert not os.path.exists(tok + ".labels.txt")
    rows = ASRDatasetBuilder.from_config(conf, "train")
    dumped = rows.dump_labels(str(tmp_path / "labels.txt"))
    with open(dumped) as f:
        assert f.read().splitlines() == [r["label"].lower() for r in rows.rows]
    assert len(BPELanguage(tok)) <= 48
