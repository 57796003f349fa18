"""Turn-key LibriSpeech-960 training recipe (the JAX package's
scripts/train_960.py, on one card or a torch.distributed group).

One command runs the whole path:

  download (optional) -> create_dataset per split -> train/valid/test
  CSVs -> BPE tokenizer -> bucket ladder from the corpus's length
  histogram -> the training CLI (crash-resume, periodic eval, best-WER
  checkpoint, bundle export) -> the test split's WER.

    python -m libreasr_tpu_torch.scripts.train_960 --root /data/LibriSpeech \\
        [--download] [--out tmp/ls960] [--steps N] [--config config/base.yaml] \\
        [--retries 100] [--device cuda]

Runs on the card unless `--device cpu` is given. The CSVs, the
tokenizer, the bucket ladder and the run config are the JAX recipe's, byte
for byte, on the same corpus. A crashed training run is started again
up to --retries times, each resuming from <out>/ckpt; the CLI's resume
restores the step, the weights and the optimizer state, and starts the
loader at the first epoch again, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import os

TRAIN_SPLITS = ("train-clean-100", "train-clean-360", "train-other-500")
VALID_SPLIT = "dev-clean"
TEST_SPLIT = "test-clean"


def find_split_dirs(root: str):
    """LibriSpeech layouts: <root>/<split> or <root>/LibriSpeech/<split>."""
    bases = [root, os.path.join(root, "LibriSpeech")]
    found = {}
    for b in bases:
        if not os.path.isdir(b):
            continue
        for split in TRAIN_SPLITS + (VALID_SPLIT, TEST_SPLIT):
            p = os.path.join(b, split)
            if os.path.isdir(p) and split not in found:
                found[split] = p
    return found


def carve_valid(train: list):
    """(train, valid): 5% of the rows drawn as pandas'
    `sample(frac=0.05, random_state=42)` draws them (RandomState(42).choice
    without replacement, in draw order), the rest in their order."""
    import numpy as np

    pick = np.random.RandomState(42).choice(
        len(train), size=round(0.05 * len(train)), replace=False)
    taken = set(pick.tolist())
    return ([r for i, r in enumerate(train) if i not in taken],
            [train[i] for i in pick])


def build_csvs(splits: dict, out_dir: str, workers: int = 8):
    """create_dataset per split dir -> merged absolute-path CSVs in
    out_dir (asr-dataset-{train,valid,test}.csv). Without dev-clean, 5% of
    train is carved off as valid; without test-clean, valid is the test
    split. Returns the train rows."""
    from ..data.builder import resolve_audio_paths
    from ..data.create_dataset import create_dataset, format_rows, read_rows

    os.makedirs(out_dir, exist_ok=True)

    def split_rows(split):
        path = splits[split]
        csv = os.path.join(path, "asr-dataset.csv")
        if not os.path.exists(csv):
            create_dataset(path, "librispeech", workers=workers)
        with open(csv, newline="") as f:
            rows = read_rows(f.read())
        if rows is None:
            raise SystemExit(f"[train-960] {csv}: not a dataset CSV")
        return resolve_audio_paths([r for r in rows if not r["bad"]], path,
                                   absolute=True)

    if not any(s in splits for s in TRAIN_SPLITS):
        raise SystemExit("no train-* split dirs found under the corpus root")
    train = [r for s in TRAIN_SPLITS if s in splits for r in split_rows(s)]
    if VALID_SPLIT in splits:
        valid = split_rows(VALID_SPLIT)
    else:
        train, valid = carve_valid(train)
    test = split_rows(TEST_SPLIT) if TEST_SPLIT in splits else valid

    for name, rows in (("train", train), ("valid", valid), ("test", test)):
        p = os.path.join(out_dir, f"asr-dataset-{name}.csv")
        with open(p, "w", newline="") as f:
            f.write(format_rows(rows))
        hours = sum(r["xlen"] for r in rows) / 3_600_000.0
        print(f"[train-960] {name}: {len(rows)} utts, {hours:.1f} h -> {p}")
    missing = [r["file"] for r in train[:20] if not os.path.exists(r["file"])]
    if missing:
        raise SystemExit(f"[train-960] resolved audio paths missing: {missing[:3]}")
    return train


def derive_buckets(conf, n_buckets: int, data_axis: int):
    """Bucket ladder from the histogram of what the loader will yield:
    the builder's training limits (almins/almaxs/y_min/y_max) first, so
    no edge is sized for utterances they discard, and label lengths in
    BPE tokens (what a bucket's max_tokens holds), not the CSV's
    characters. Batch sizes are multiples of `data_axis`."""
    from ..data.batching import buckets_from_histogram
    from ..data.builder import ASRDatasetBuilder
    from ..data.language import get_language

    b = ASRDatasetBuilder.from_config(conf, "train")
    lang, _ = get_language(model_file=conf["tokenizer"]["model_file"])
    ylen_tok = [len(lang.numericalize(str(r["label"]))) for r in b.rows]
    xlen = [r["xlen"] for r in b.rows]
    print(f"[train-960] post-limit corpus: {len(b.rows)} utts, "
          f"{sum(xlen) / 3_600_000.0:.1f} h "
          f"(almaxs {conf.get('almaxs', 6.0)} s, "
          f"y_max {conf.get('y_max', 60)} chars)")

    buckets = buckets_from_histogram(
        xlen, ylen_tok, sr=conf.get("sr", 16000),
        n_buckets=n_buckets, data_axis=data_axis,
    )
    print("[train-960] bucket ladder from length histogram:")
    for bk in buckets:
        print(f"  max {bk.max_samples / conf.get('sr', 16000):5.1f} s  "
              f"y_max {bk.max_tokens:3d}  bs {bk.bs}")
    return [
        {"max_samples": bk.max_samples, "y_max": bk.max_tokens, "bs": bk.bs}
        for bk in buckets
    ]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", required=True, help="LibriSpeech corpus root")
    p.add_argument("--out", default="tmp/ls960", help="work dir (CSVs, "
                   "tokenizer, checkpoints, bundle)")
    p.add_argument("--config", default="config/base.yaml")
    p.add_argument("--download", action="store_true",
                   help="download missing LibriSpeech splits first")
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--retries", type=int, default=100,
                   help="crash-resume relaunches")
    p.add_argument("--n-buckets", type=int, default=4)
    p.add_argument("--vocab-sz", type=int, default=0,
                   help="BPE vocab (default: config wanted_vocab_sz)")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--eval-batches", type=int, default=16)
    p.add_argument("--eval-every", type=int, default=250,
                   help="eval cadence in steps")
    p.add_argument("--skip-final-eval", action="store_true")
    p.add_argument("--chain-steps", type=int, default=8,
                   help="run up to K same-bucket train steps as one chain "
                        "(the training CLI's --chain-steps)")
    p.add_argument("--ckpt-every-s", type=float, default=600.0)
    p.add_argument("--accumulate", type=int, default=0,
                   help="override accumulate_n_batches (0: keep the "
                        "config's; small corpora want 1)")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="dotted config override, e.g. "
                        "model.encoder.use_tmp_state_pcent=0.25 "
                        "(YAML-parsed value; repeatable)")
    p.add_argument("--no-augment", action="store_true",
                   help="strip the randomized augmentation stages (speed "
                        "perturbation, SpecAugment, noise, shifts)")
    p.add_argument("--device", default="cuda",
                   help="the training CLI's and the final eval's device")
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)

    import yaml

    from .. import resolve_device
    from ..config import open_config
    from ..data.builder import ASRDatasetBuilder
    from ..parallel import distributed as dist

    resolve_device(a.device)
    if a.download:
        from .download_corpora import CORPORA, download

        for name in CORPORA:
            if name.startswith("librispeech"):
                download(name, a.root)

    splits = find_split_dirs(a.root)
    if not splits:
        raise SystemExit(f"no LibriSpeech split dirs under {a.root}")
    print(f"[train-960] splits: {sorted(splits)}")

    out = a.out
    os.makedirs(out, exist_ok=True)
    conf = open_config(a.config)
    build_csvs(splits, out, workers=a.workers)

    conf["datasets"] = ["ls960"]
    conf["dataset_paths"] = {"ls960": out}
    conf["num_workers"] = max(int(conf.get("num_workers", 3)), a.workers)
    # full-shape batches only: the shuffled spill trains on everything
    # across epochs anyway
    conf["drop_last"] = True
    if a.accumulate:
        conf["accumulate_n_batches"] = a.accumulate
    tok_file = os.path.join(out, "tokenizer.bpe-model")
    conf.setdefault("tokenizer", {})["model_file"] = tok_file
    conf["train_tokenizer"] = False
    if not os.path.exists(tok_file):
        vocab = a.vocab_sz or conf.get("wanted_vocab_sz", 2048)
        print(f"[train-960] training BPE tokenizer (vocab {vocab}) ...")
        ASRDatasetBuilder.from_config(conf, "train").train_tokenizer(tok_file, vocab)

    # the data axis a batch splits over: the process group's world (1
    # without a group) over the config's model axis
    data_axis = dist.process_count()
    if (conf.get("mesh", {}) or {}).get("model", 1) > 1:
        data_axis = max(data_axis // conf["mesh"]["model"], 1)
    conf["buckets"] = derive_buckets(conf, a.n_buckets, data_axis)

    if a.no_augment:
        tf = conf.get("transforms") or {}
        for k, stages in tf.items():
            if isinstance(stages, list):
                tf[k] = [s for s in stages if not (s or {}).get("wrap")]
        print("[train-960] randomized augmentation stages stripped")

    for kv in a.set:
        key, sep, val = kv.partition("=")
        if not sep:
            raise SystemExit(f"--set expects K=V, got {kv!r}")
        d = conf
        *parents, leaf = key.split(".")
        for part in parents:
            d = d.setdefault(part, {})
        d[leaf] = yaml.safe_load(val)
        print(f"[train-960] override {key} = {d[leaf]!r}")

    gen_conf = os.path.join(out, "train960.yaml")
    with open(gen_conf, "w") as f:
        yaml.safe_dump(conf, f, sort_keys=False)
    print(f"[train-960] config -> {gen_conf}")

    from ..train import main as train_main

    bundle_out = os.path.join(out, "model.tar.gz")
    ckpt = os.path.join(out, "ckpt")
    args = [
        "--config", gen_conf, "--ckpt", ckpt, "--bundle-out", bundle_out,
        "--logdir", os.path.join(out, "runs"),
        "--eval-batches", str(a.eval_batches),
        "--eval-every", str(a.eval_every),
        "--chain-steps", str(a.chain_steps),
        "--ckpt-every-s", str(a.ckpt_every_s),
        "--device", a.device,
    ]
    if a.steps:
        args += ["--steps", str(a.steps)]
    for attempt in range(a.retries):
        try:
            train_main(args)
            break
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 - crash-resume from the checkpoint
            print(f"[train-960] run crashed ({type(e).__name__}: {e}); "
                  f"resuming from {ckpt} ({attempt + 1}/{a.retries})")
    else:
        raise SystemExit("train-960: out of retries")

    if not a.skip_final_eval:
        from .evaluate_wer import main as eval_main

        print("[train-960] final test-split WER:")
        eval_main([
            "--dataset", out, "--split", "test", "--bundle", bundle_out,
            "--config", gen_conf, "--device", a.device,
        ])
    print(f"[train-960] done: bundle at {bundle_out}")


if __name__ == "__main__":
    main()
