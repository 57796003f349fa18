"""The port's LibriSpeech-960 recipe (libreasr_tpu_torch/scripts/
train_960.py) against the JAX package's scripts/train_960.py, on mock
LibriSpeech trees of noise WAVs (tests/test_train_960.py's writer) and
the tiny model of tests/test_train_960.py, on the CPU.

- build_csvs writes JAX's three CSVs byte for byte, with dev-clean and
  without it (5% of train carved off as pandas' sample draws it, and
  valid standing in for the missing test split);
- JAX's recipe with its training CLI a no-op writes the tokenizer and
  train960.yaml: the port's are the same bytes and the same config apart
  from paths, and the bucket ladders equal JAX's for data axes 1 and 8;
- the port's recipe trains, exports, reloads and transcribes, and scores
  the test split;
- a crash injected after step 2 of 4 resumes at step 2 and ends at 4;
- --download extracts LibriSpeech tarballs already in --root as the JAX
  package's download does, fetching nothing, and a training call that
  always fails ends in "out of retries"."""

import contextlib
import importlib.util
import io
import os
import shutil
import sys
import tarfile

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from libreasr_tpu_torch import train as cli
from libreasr_tpu_torch.api import ASRBundle
from libreasr_tpu_torch.config import open_config
from libreasr_tpu_torch.data.builder import pandas_float
from libreasr_tpu_torch.data.create_dataset import create_dataset
from libreasr_tpu_torch.scripts import download_corpora
from libreasr_tpu_torch.scripts import train_960 as recipe
from test_train_960 import _write_split

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["hello world", "the cat sat on the mat", "speech is fun",
         "jax on tpu", "one two three four", "testing audio now",
         "more data here", "almost done", "turn right", "go left"]
CSVS = [f"asr-dataset-{s}.csv" for s in ("train", "valid", "test")]
FLAGS = ["--retries", "2", "--n-buckets", "2", "--vocab-sz", "64",
         "--workers", "2", "--eval-batches", "1", "--chain-steps", "1"]


def _load(name, rel):
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_recipe():
    return _load("jax_train_960", "scripts/train_960.py")


def _corpus(root, splits, seed=7):
    """A LibriSpeech-shaped tree under <root>/LibriSpeech: {split: utts}."""
    rng = np.random.default_rng(seed)
    corpus = os.path.join(str(root), "LibriSpeech")
    for split, n in splits.items():
        _write_split(corpus, split, n, rng, TEXTS)
    return corpus


FULL = {"train-clean-100": 40, "dev-clean": 8, "test-clean": 8}
# no dev-clean and no test-clean: valid is carved, and is the test split
CARVE = {"train-clean-100": 30, "train-other-500": 31}


def _tiny_config(path):
    """tests/test_train_960.py's model: 1 layer a tower, 16 wide, f32."""
    conf = open_config(os.path.join(ROOT, "config", "base.yaml"))
    conf["model"].update(feature_sz=1280, embed_sz=8, hidden_sz=16, out_sz=16,
                         joint_sz=16, vocab_sz=64)
    conf["model"]["encoder"]["num_layers"] = 1
    conf["model"]["predictor"]["num_layers"] = 1
    conf["dtypes"]["compute"] = "float32"
    conf["accumulate_n_batches"] = 1
    conf["lm"]["enable"] = False
    conf["tensorboard"] = False
    with open(path, "w") as f:
        yaml.safe_dump(conf, f, sort_keys=False)
    return str(path)


def _split_csvs(corpus):
    """Each split's asr-dataset.csv, written by the port's create_dataset
    in threads (its bytes equal JAX's: tests/test_torch_dataset_tools.py),
    so that neither recipe spawns a process pool to make it."""
    with contextlib.redirect_stdout(io.StringIO()):
        for d in recipe.find_split_dirs(os.path.dirname(corpus)).values():
            create_dataset(d, "librispeech", workers=2, pool="thread")


@pytest.mark.parametrize("layout", ["full", "carve"])
def test_build_csvs_bytes_equal_jax(tmp_path, layout):
    corpus = _corpus(tmp_path, FULL if layout == "full" else CARVE)
    _split_csvs(corpus)
    splits = recipe.find_split_dirs(str(tmp_path))
    assert splits == _jax_recipe().find_split_dirs(str(tmp_path))
    with contextlib.redirect_stdout(io.StringIO()):
        _jax_recipe().build_csvs(splits, str(tmp_path / "jax"), workers=2)
        rows = recipe.build_csvs(splits, str(tmp_path / "port"), workers=2)
    for name in CSVS:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    n_valid = len((tmp_path / "port" / CSVS[1]).read_text().splitlines()) - 1
    if layout == "carve":
        assert n_valid == round(0.05 * 61) and len(rows) == 61 - n_valid
        assert (tmp_path / "port" / CSVS[1]).read_bytes() == \
            (tmp_path / "port" / CSVS[2]).read_bytes()
    else:
        assert n_valid == 8 and len(rows) == 40
    assert all(os.path.isabs(r["file"]) for r in rows)


def test_csv_floats_read_as_pandas_reads_them():
    """The merged CSVs pass through pandas in JAX's recipe: its C parser
    (precise_xstrtod) does not always give the nearest double, and its
    to_csv writes what it read. The port's reader (pandas_float) gives
    pandas' value on durations as create_dataset writes them and on
    other floats, where float() differs on about a fifth of them."""
    rng = np.random.default_rng(3)
    cells = [repr(int(n) / int(sr) * 1000.0) for n, sr in zip(
        rng.integers(1, 200_000, 2000), rng.choice([8000, 16000, 22050, 44100], 2000))]
    cells += [repr(float(x)) for x in rng.standard_normal(1000) * 10.0 ** rng.integers(-8, 12, 1000)]
    cells += ["1015.9374999999999", "0.000123", "1e5", "-3.5e-3", "5.", "-0", "12345678901234567890.5"]
    ref = pd.read_csv(io.StringIO("x\n" + "\n".join(cells) + "\n"))["x"].tolist()
    assert [pandas_float(c) for c in cells] == ref
    assert sum(float(c) != r for c, r in zip(cells, ref)) > 100


@pytest.mark.parametrize("n", [1, 7, 20, 61, 1000])
def test_carve_draws_pandas_rows(n):
    rows = [{"i": i} for i in range(n)]
    df = pd.DataFrame(rows)
    valid = df.sample(frac=0.05, random_state=42)
    train = df.drop(valid.index)
    got_train, got_valid = recipe.carve_valid(rows)
    assert [r["i"] for r in got_valid] == valid["i"].tolist()
    assert [r["i"] for r in got_train] == train["i"].tolist()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's recipe with its training CLI a no-op (CSVs, tokenizer,
    ladder, config), then the port's recipe on the same corpus: 4 steps
    on the CPU with an eval every 2, the export and the test split's WER."""
    d = tmp_path_factory.mktemp("ls960")
    corpus = _corpus(d, FULL)
    _split_csvs(corpus)
    conf_path = _tiny_config(d / "tiny.yaml")
    jax_recipe = _jax_recipe()
    import train as jax_train_cli

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_train_cli, "main", lambda argv=None: None)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            jax_recipe.main(["--root", corpus, "--out", str(d / "jax"),
                             "--config", conf_path, "--steps", "4",
                             "--skip-final-eval", *FLAGS])
    finally:
        mp.undo()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        recipe.main(["--root", corpus, "--out", str(d / "port"), "--config",
                     conf_path, "--steps", "4", "--eval-every", "2",
                     "--device", "cpu", *FLAGS])
    return d, corpus, conf_path, jax_recipe, buf.getvalue()


def test_tokenizer_config_and_ladder_equal_jax(runs):
    import jax

    d, _, _, jax_recipe, _ = runs
    port, ref = d / "port", d / "jax"
    for name in CSVS + ["tokenizer.bpe-model"]:
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name
    pc = yaml.safe_load((port / "train960.yaml").read_text())
    jc = yaml.safe_load((ref / "train960.yaml").read_text())
    assert pc["dataset_paths"] == {"ls960": str(port)}
    assert jc["dataset_paths"] == {"ls960": str(ref)}
    assert pc["tokenizer"]["model_file"] == str(port / "tokenizer.bpe-model")
    # JAX's ladder rounds batches to its 8 CPU devices, the port's to a
    # world of one process
    jax_axis = jax.device_count()
    pb, jb = pc.pop("buckets"), jc.pop("buckets")
    for c in (pc, jc):
        c["dataset_paths"] = c["tokenizer"]["model_file"] = None
    assert pc == jc
    with contextlib.redirect_stdout(io.StringIO()):
        port_ladders = {a: recipe.derive_buckets(dict(pc, **_paths(port)), 2, a) for a in (1, 8)}
        jax_ladders = {a: jax_recipe.derive_buckets(dict(jc, **_paths(ref)), 2, a)
                       for a in (1, 8)}
    assert port_ladders == jax_ladders
    assert pb == port_ladders[1] and jb == port_ladders[jax_axis]
    assert len(pb) == 2 and all(b["bs"] % 8 == 0 for b in port_ladders[8])


def _paths(out):
    return {"dataset_paths": {"ls960": str(out)},
            "tokenizer": {"model_file": str(out / "tokenizer.bpe-model")}}


def test_port_run_exports_reloads_and_scores(runs, tmp_path):
    d, _, _, _, out = runs
    port = d / "port"
    for name in CSVS + ["tokenizer.bpe-model", "train960.yaml", "model.tar.gz"]:
        assert (port / name).exists(), name
    assert "[train] done: step=4" in out
    assert out.count("[eval] step=") == 3  # steps 2 and 4, and the CLI's last
    assert "[train-960] final test-split WER:" in out
    assert "[eval] n=8 WER=" in out
    assert out.rstrip().endswith(f"[train-960] done: bundle at {port / 'model.tar.gz'}")
    bundle = ASRBundle.from_bundle(str(port / "model.tar.gz"),
                                   extract_to=str(tmp_path / "x"), device="cpu")
    assert bundle.cfg.hidden_sz == 16 and len(bundle.lang) == 64
    text, _ = bundle.transcribe(np.zeros(16000, np.float32))
    assert isinstance(text, str)


def test_crash_resumes_from_the_checkpoint(runs, tmp_path, monkeypatch):
    """The first launch ends at step 2 and raises; the recipe launches the
    CLI again, which resumes at step 2 from <out>/ckpt and ends at 4. The
    CLI's resume restores the weights, optimizer state and generators but
    starts the loader at the first epoch again (as JAX's train.py does),
    so steps 3 and 4 see the batches of steps 1 and 2, and the final
    parameters are not the uninterrupted run's: held here are the resume
    step and the step count."""
    d, corpus, conf_path, _, _ = runs
    real, calls = cli.main, []

    def crash_once(argv):
        calls.append(list(argv))
        if len(calls) == 1:
            i = argv.index("--steps")
            real(argv[:i + 1] + ["2"] + argv[i + 2:])
            raise RuntimeError("injected crash after step 2")
        return real(argv)

    monkeypatch.setattr(cli, "main", crash_once)
    buf = io.StringIO()
    out = tmp_path / "crash"
    with contextlib.redirect_stdout(buf):
        recipe.main(["--root", corpus, "--out", str(out), "--config", conf_path,
                     "--steps", "4", "--eval-every", "2", "--device", "cpu",
                     "--skip-final-eval", *FLAGS])
    text = buf.getvalue()
    assert len(calls) == 2 and calls[0] == calls[1]
    assert ("[train-960] run crashed (RuntimeError: injected crash after step 2); "
            f"resuming from {out / 'ckpt'} (1/2)") in text
    assert f"[train] resumed from {out / 'ckpt'} at step 2" in text
    assert "[train] done: step=2" in text and "[train] done: step=4" in text
    state = torch.load(out / "ckpt" / "train_state.pt", map_location="cpu",
                       weights_only=True)
    assert state["step"] == 4
    assert "final test-split" not in text


def _tarballs(root, src):
    """One tarball a LibriSpeech split, named as OpenSLR names it, each
    holding LibriSpeech/<split>/... of the mock tree at `src`."""
    os.makedirs(root, exist_ok=True)
    for url in download_corpora.CORPORA.values():
        split = os.path.basename(url)[: -len(".tar.gz")]
        with tarfile.open(os.path.join(root, os.path.basename(url)), "w:gz") as t:
            if os.path.isdir(os.path.join(src, split)):
                t.add(os.path.join(src, split), arcname=f"LibriSpeech/{split}")


def _tree(root):
    """The extracted files (not the tarballs, nor the CSVs build_csvs
    writes into each split) and their bytes."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if not f.endswith((".tar.gz", "asr-dataset.csv")):
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_download_extracts_offline_tarballs_then_out_of_retries(tmp_path, monkeypatch):
    src = _corpus(tmp_path / "src", {"train-clean-100": 12, "test-clean": 4})
    _tarballs(str(tmp_path / "port"), src)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")

    def no_network(*a, **k):
        raise AssertionError("a download was attempted")

    monkeypatch.setattr(download_corpora.urllib.request, "urlretrieve", no_network)
    jax_dl = _load("jax_download_corpora", "scripts/download_corpora.py")
    assert jax_dl.CORPORA == download_corpora.CORPORA
    calls = []

    def always_fails(argv):
        calls.append(argv)
        raise RuntimeError("boom")

    monkeypatch.setattr(cli, "main", always_fails)
    with contextlib.redirect_stdout(io.StringIO()):
        for name in jax_dl.CORPORA:
            jax_dl.download(name, str(tmp_path / "jax"))
        with pytest.raises(SystemExit, match="train-960: out of retries"):
            recipe.main(["--root", str(tmp_path / "port"), "--download",
                         "--out", str(tmp_path / "work"), "--device", "cpu",
                         "--config", _tiny_config(tmp_path / "tiny.yaml"),
                         "--steps", "2", *FLAGS[2:], "--retries", "1"])
    assert len(calls) == 1
    port_tree = _tree(tmp_path / "port")
    assert port_tree == _tree(tmp_path / "jax")
    assert sum(p.endswith(".wav") for p in port_tree) == 16
    assert recipe.find_split_dirs(str(tmp_path / "port")) == {
        s: str(tmp_path / "port" / "LibriSpeech" / s)
        for s in ("train-clean-100", "test-clean")}


def test_recipe_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        recipe.main(["--root", str(tmp_path), "--out", str(tmp_path / "w")])
    assert not (tmp_path / "w").exists()
