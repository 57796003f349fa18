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
    for flag in (["--chain-steps", "2"], ["--pp", "2"], ["--mesh-model", "2"],
                 ["--dist-coordinator", "h:1"]):
        with pytest.raises(NotImplementedError, match="not ported"):
            cli.main(["--config", conf_path, "--device", "cpu", *flag])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--config", conf_path])


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
