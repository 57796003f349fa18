"""The port's tone recipe (libreasr_tpu_torch/scripts/train_tone_stream.py)
against the JAX package's scripts/train_tone_stream.py on the same tiny
--config (the 1-layer, 12-wide model of tests/test_synth_stream.py):
the same tokenizer bytes and the same run config outside the bucket
ladder (JAX rounds its batch sizes to its 8 CPU devices, the port to its
one card). Then the port's run on the CPU trains, evaluates, keeps the
best-WER checkpoint, re-exports it as the bundle and prints the test WER
by length; the training CLI refuses a stream that yields no batch;
make_tone_corpus writes the JAX script's WAVs and the CSVs that JAX's
create_dataset makes of them; and evaluate_wer scores that corpus with
the recipe's bundle."""

import contextlib
import csv
import importlib.util
import io
import os
import sys

import pytest
import torch
import yaml

from libreasr_tpu_torch import train as cli
from libreasr_tpu_torch.api import ASRBundle
from libreasr_tpu_torch.data.synth import ToneStreamDataset
from libreasr_tpu_torch.scripts import evaluate_wer, make_tone_corpus
from libreasr_tpu_torch.scripts import train_tone_stream as recipe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = {  # tests/test_synth_stream.py's model and training block
    "sr": 16000,
    "melkwargs": {"n_fft": 1024, "n_mels": 128},
    "win_length": 0.025, "hop_length": 0.01, "deltas": 0,
    "mesh": {"data": -1, "model": 1},
    "dtypes": {"param": "float32", "compute": "float32"},
    "model": {
        "name": "Transducer",
        "feature_sz": 1280, "embed_sz": 8, "hidden_sz": 12,
        "out_sz": 12, "joint_sz": 12, "vocab_sz": 40,
        "encoder": {"rnn_type": "LSTM", "num_layers": 1, "dropout": 0.0,
                    "reduction_factor": 1, "use_tmp_state_pcent": 0.0},
        "predictor": {"rnn_type": "NBRC", "num_layers": 1,
                      "dropout": 0.0, "use_tmp_state_pcent": 0.0},
        "joint": {"method": "concat", "dropout": 0.0},
        "use_tmp_bos": False, "use_tmp_bos_pcent": 0.2,
    },
    "training": {"optimizer": "adam", "lr": 1e-3, "wd": 0.0,
                 "epochs": 1, "warmup_pct": 0.1, "grad_clip": 10.0},
    "bs": 4, "accumulate_n_batches": 1, "seed": 3,
    "tensorboard": False, "wandb": False, "tests_per_epoch": 1,
    "lm": {"enable": False},
    "loss": {"type": "rnnt"},
}
COMMON = ["--hours-per-epoch", "0.05", "--eval-utts", "8", "--eval-batches", "1",
          "--num-workers", "2", "--set", "training.lr=0.002"]


def _jax_recipe():
    spec = importlib.util.spec_from_file_location(
        "jax_train_tone_stream", os.path.join(ROOT, "scripts", "train_tone_stream.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's recipe with its training CLI a no-op (it writes the
    tokenizer corpus, the tokenizer and the config), then the port's
    recipe for 2 steps on the CPU with an eval every step."""
    d = tmp_path_factory.mktemp("recipe")
    conf_path = d / "tiny.yaml"
    conf_path.write_text(yaml.safe_dump(TINY))
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import train as jax_train_cli

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_train_cli, "main", lambda argv=None: None)
    try:
        _jax_recipe().main(["--out", str(d / "jax"), "--config", str(conf_path),
                            "--skip-final-eval", *COMMON])
    finally:
        mp.undo()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        recipe.main(["--out", str(d / "port"), "--config", str(conf_path),
                     "--device", "cpu", "--steps", "2", "--eval-every", "1", *COMMON])
    return d, buf.getvalue()


def test_tokenizer_and_config_equal_jax(runs):
    d, _ = runs
    for name in ("tokenizer_corpus.txt", "tokenizer.bpe-model"):
        assert (d / "port" / name).read_bytes() == (d / "jax" / name).read_bytes()
    port = yaml.safe_load((d / "port" / "tone_stream.yaml").read_text())
    ref = yaml.safe_load((d / "jax" / "tone_stream.yaml").read_text())
    assert port["tokenizer"]["model_file"] == str(d / "port" / "tokenizer.bpe-model")
    assert ref["tokenizer"]["model_file"] == str(d / "jax" / "tokenizer.bpe-model")
    for c in (port, ref):
        c["tokenizer"]["model_file"] = "tokenizer.bpe-model"
    port_buckets, ref_buckets = port.pop("buckets"), ref.pop("buckets")
    assert port == ref
    assert port["model"]["encoder"]["norm"] == "layer"
    assert port["synth_tone"]["enabled"] and port["drop_last"]
    assert len(port_buckets) == len(ref_buckets) == 3
    assert [b["max_samples"] for b in port_buckets] == \
        [b["max_samples"] for b in ref_buckets]
    assert all(b["bs"] % 8 == 0 for b in ref_buckets)


def test_port_run_trains_exports_and_scores_test(runs):
    d, out = runs
    port = d / "port"
    assert out.count("[eval] step=") == 3  # steps 1, 2 and the run's end
    assert "[train] done: step=2" in out
    assert (port / "ckpt" / "train_state.pt").exists()
    assert (port / "ckpt_best_wer" / "train_state.pt").exists()
    assert "best-dev-WER checkpoint (step " in out
    assert (port / "model_final.tar.gz").exists() and (port / "model.tar.gz").exists()
    bundle = ASRBundle.from_bundle(str(port / "model.tar.gz"),
                                   extract_to=str(d / "x"), device="cpu")
    # every test row the batcher emits: a bucket's leftover of one is
    # dropped (batch norm needs two rows), as in JAX
    conf = yaml.safe_load((port / "tone_stream.yaml").read_text())
    rows = sum(len(b.audio) for b in ToneStreamDataset.from_config(
        conf, bundle.lang, "test"))
    assert 8 - len(conf["buckets"]) <= rows <= 8
    test_line = [ln for ln in out.splitlines() if ln.startswith("[tone-stream] TEST")]
    assert len(test_line) == 1 and f" n={rows}" in test_line[0]
    assert "  WER[" in out
    assert bundle.lang.vocab == ASRBundle.from_bundle(
        str(port / "model_final.tar.gz"), extract_to=str(d / "y"),
        device="cpu").lang.vocab
    with open(port / "tokenizer.bpe-model") as f:
        assert bundle.lang.vocab == f.read().splitlines()[3:3 + len(bundle.lang)]
    assert bundle.cfg.vocab_sz == max(TINY["model"]["vocab_sz"], len(bundle.lang))


def test_export_only_rescores(runs):
    d, _ = runs
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        recipe.main(["--out", str(d / "port"), "--export-only", "--device", "cpu"])
    out = buf.getvalue()
    assert "best-dev-WER checkpoint" in out and "[tone-stream] TEST" in out
    with pytest.raises(SystemExit, match="no run config"):
        recipe.main(["--out", str(d / "none"), "--export-only", "--device", "cpu"])


def test_train_cli_zero_batch_guard(tmp_path):
    """A stream whose only bucket never fills under drop_last (~4 utts an
    epoch, bs 64) stops the CLI instead of spinning through empty epochs."""
    conf = {**TINY,
            "synth_tone": {"enabled": True, "hours_per_epoch": 0.002, "speakers": 4,
                           "heldout_speakers": 2, "eval_utts": 8, "seed": 7},
            "num_workers": 2, "drop_last": True,
            "buckets": [{"max_samples": 80000, "y_max": 64, "bs": 64}]}
    path = tmp_path / "conf.yaml"
    path.write_text(yaml.safe_dump(conf))
    with pytest.raises(SystemExit, match="no batch"):
        cli.main(["--config", str(path), "--steps", "2", "--device", "cpu",
                  "--ckpt", str(tmp_path / "ckpt"), "--logdir", str(tmp_path / "runs"),
                  "--eval-every", "2"])


def test_ladder_too_big_for_an_epoch_raises(tmp_path):
    with pytest.raises(SystemExit, match="hours-per-epoch"):
        recipe.main(["--out", str(tmp_path), "--config", os.path.join(
            ROOT, "config", "base.yaml"), "--hours-per-epoch", "0.005",
            "--device", "cpu"])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The port's corpus and the JAX script's, on the same arguments."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        from make_tone_corpus import main as jax_make
    finally:
        sys.path.pop(0)
    d = tmp_path_factory.mktemp("corpus")
    argv = ["--train", "6", "--valid", "3", "--test", "5", "--speakers", "3",
            "--heldout-speakers", "2", "--seed", "4"]
    make_tone_corpus.main(["--out", str(d / "port"), *argv])
    jax_make(["--out", str(d / "jax"), *argv])
    return d


def test_make_tone_corpus_equals_jax(corpus):
    from libreasr_tpu.data.create_dataset import create_dataset

    files = []
    for root, _, names in os.walk(corpus / "jax"):
        files += [os.path.relpath(os.path.join(root, n), corpus / "jax") for n in names]
    assert len(files) == 14 + 7  # the WAVs, a trans.txt a speaker and split
    for rel in files:
        assert (corpus / "port" / rel).read_bytes() == (corpus / "jax" / rel).read_bytes()
    for split, n in zip(make_tone_corpus.SPLITS, (6, 3, 5)):
        create_dataset(str(corpus / "jax" / split), "librispeech", workers=1,
                       pool="thread")
        with open(corpus / "jax" / split / "asr-dataset.csv") as f:
            ref = {os.path.relpath(r["file"], corpus / "jax" / split): r
                   for r in csv.DictReader(f)}
        with open(corpus / "port" / split / "asr-dataset.csv") as f:
            got = {r["file"]: r for r in csv.DictReader(f)}
        assert sorted(got) == sorted(ref) and len(got) == n
        for k, r in got.items():
            assert r["label"] == ref[k]["label"] and r["ylen"] == ref[k]["ylen"]
            assert float(r["xlen"]) == float(ref[k]["xlen"])
            assert (r["xstart"], r["sr"], r["bad"]) == \
                (ref[k]["xstart"], ref[k]["sr"], ref[k]["bad"])


def test_evaluate_wer_on_corpus(runs, corpus, capsys):
    d, _ = runs
    res = evaluate_wer.main(["--dataset", str(corpus / "port" / "test-clean"),
                             "--bundle", str(d / "port" / "model.tar.gz"),
                             "--beam", "4", "--bs", "2", "--max-utts", "4",
                             "--device", "cpu"])
    out = capsys.readouterr().out
    assert res.n == 4 and "[eval] n=4 WER=" in out and "  WER[" in out
    with pytest.raises(NotImplementedError, match="never applies it"):
        evaluate_wer.main(["--dataset", str(corpus / "port" / "test-clean"),
                           "--use-lm", "--device", "cpu"])


def test_recipe_entry_points_default_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        recipe.main(["--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_wer.main(["--dataset", str(tmp_path)])
