"""Train the transducer on the streamed tone corpus (data/synth.py),
turn-key: tokenizer -> bucket ladder from a sampled length histogram ->
the training CLI with crash-resume, periodic dev eval and best-WER
checkpoint -> the best checkpoint exported as the bundle -> WER on the
held-out test split (held-out speakers and sentences). Nothing is
written to disk but the tokenizer's text sample, the config, the
checkpoints and the bundle. The port of the JAX package's
scripts/train_tone_stream.py, on one card.

    python -m libreasr_tpu_torch.scripts.train_tone_stream \\
        --out tmp/flagship_stream [--steps 20000] [--hours-per-epoch 0.5] \\
        [--speakers 16] [--vocab-sz 64] [--config config/base.yaml] \\
        [--set K=V ...] [--device cuda]

Runs on the card unless `--device cpu` is given. One step a dispatch
(the JAX recipe's chained steps take the same batches in the same
order).
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="tmp/flagship_stream")
    p.add_argument("--config", default="config/base.yaml")
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--hours-per-epoch", type=float, default=0.5)
    p.add_argument("--speakers", type=int, default=16)
    p.add_argument("--heldout-speakers", type=int, default=4)
    p.add_argument("--eval-utts", type=int, default=96)
    p.add_argument("--vocab-sz", type=int, default=64,
                   help="BPE vocab (near-char subwords generalize on this "
                        "task; whole-word tokens memorize)")
    p.add_argument("--eval-every", type=int, default=500)
    p.add_argument("--eval-batches", type=int, default=8)
    p.add_argument("--retries", type=int, default=50)
    p.add_argument("--num-workers", type=int, default=6)
    p.add_argument("--ckpt-every-s", type=float, default=600.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--bs-max", type=int, default=16,
                   help="bucket batch-size cap (the recipe's ladder)")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="dotted config override (YAML value; repeatable)")
    p.add_argument("--skip-final-eval", action="store_true")
    p.add_argument("--export-only", action="store_true",
                   help="skip training; re-export the best-dev-WER bundle "
                        "from an existing --out tree and run the test eval")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def recipe_config(a, tok_file: str) -> dict:
    """The config file with the recipe's settings, before its buckets."""
    import yaml

    from ..config import open_config

    conf = open_config(a.config)
    conf.setdefault("tokenizer", {})["model_file"] = tok_file
    conf["train_tokenizer"] = False
    conf["synth_tone"] = {
        "enabled": True,
        "hours_per_epoch": a.hours_per_epoch,
        "speakers": a.speakers,
        "heldout_speakers": a.heldout_speakers,
        "eval_utts": a.eval_utts,
        "seed": a.seed,
    }
    conf["num_workers"] = a.num_workers
    conf["drop_last"] = True
    conf["accumulate_n_batches"] = 1
    # frequency-coded audio is corrupted by speed and mask augmentation:
    # strip every randomized stage
    tf = conf.get("transforms") or {}
    for k, stages in tf.items():
        if isinstance(stages, list):
            tf[k] = [s for s in stages if not (s or {}).get("wrap")]
    for tower in ("encoder", "predictor"):
        conf["model"][tower]["use_tmp_state_pcent"] = 0.25
        conf["model"][tower]["norm"] = "layer"
    for kv in a.set:
        key, sep, val = kv.partition("=")
        if not sep:
            raise SystemExit(f"--set expects K=V, got {kv!r}")
        d = conf
        *parents, leaf = key.split(".")
        for part in parents:
            d = d.setdefault(part, {})
        d[leaf] = yaml.safe_load(val)
        print(f"[tone-stream] override {key} = {d[leaf]!r}")
    return conf


def bucket_ladder(conf: dict, lang, bs_max: int, hours_per_epoch: float):
    """Three buckets from the lengths of 512 generated utterances (one
    card: data axis 1). Raises SystemExit when an epoch is too short to
    fill them under drop_last (the loader would yield no batch)."""
    from ..data.batching import buckets_from_histogram
    from ..data.synth import ToneStreamDataset

    probe = ToneStreamDataset.from_config(conf, lang, "train")
    xl, yl = probe.sample_lengths(512)
    buckets = buckets_from_histogram(xl, yl, sr=conf.get("sr", 16000),
                                     n_buckets=3, data_axis=1, bs_max=bs_max)
    per_epoch = int(hours_per_epoch * 3600 / 1.6)
    need = sum(b.bs for b in buckets) * 2
    if per_epoch < need:
        raise SystemExit(
            f"[tone-stream] --hours-per-epoch {hours_per_epoch} gives "
            f"~{per_epoch} utts/epoch but the bucket ladder needs >={need} "
            "to fill reliably under drop_last; raise it")
    return buckets


def main(argv=None):
    a = parse_args(argv)
    import numpy as np
    import yaml

    from .. import resolve_device
    from ..config import open_config
    from ..data.bpe import train_bpe
    from ..data.language import get_language
    from ..data.synth import sentences

    resolve_device(a.device)
    out = a.out
    os.makedirs(out, exist_ok=True)
    gen_conf = os.path.join(out, "tone_stream.yaml")
    tok_file = os.path.join(out, "tokenizer.bpe-model")
    bundle_out = os.path.join(out, "model.tar.gz")
    ckpt = os.path.join(out, "ckpt")

    if a.export_only:
        if not os.path.exists(gen_conf):
            raise SystemExit(f"--export-only: no run config at {gen_conf}")
        export_best_bundle(out, gen_conf, tok_file, ckpt, bundle_out)
        if not a.skip_final_eval:
            final_test_eval(out, open_config(gen_conf), bundle_out, a.device)
        print(f"[tone-stream] done: bundle at {bundle_out}")
        return

    # the tokenizer, trained on a generated text sample (never audio)
    if not os.path.exists(tok_file):
        corpus = os.path.join(out, "tokenizer_corpus.txt")
        with open(corpus, "w") as f:
            for s in sentences(np.random.default_rng([a.seed, 6]), 8000):
                f.write(s + "\n")
        print(f"[tone-stream] training BPE tokenizer (vocab {a.vocab_sz})")
        train_bpe(corpus, tok_file, a.vocab_sz)

    conf = recipe_config(a, tok_file)
    lang, _ = get_language(model_file=tok_file)
    buckets = bucket_ladder(conf, lang, a.bs_max, a.hours_per_epoch)
    print("[tone-stream] bucket ladder:")
    for b in buckets:
        print(f"  max {b.max_samples / conf.get('sr', 16000):5.1f} s  "
              f"y_max {b.max_tokens:3d}  bs {b.bs}")
    conf["buckets"] = [
        {"max_samples": b.max_samples, "y_max": b.max_tokens, "bs": b.bs}
        for b in buckets
    ]
    with open(gen_conf, "w") as f:
        yaml.safe_dump(conf, f, sort_keys=False)
    print(f"[tone-stream] config -> {gen_conf}")

    from ..train import main as train_main

    args = [
        "--config", gen_conf, "--ckpt", ckpt, "--bundle-out", bundle_out,
        "--logdir", os.path.join(out, "runs"),
        "--eval-batches", str(a.eval_batches),
        "--eval-every", str(a.eval_every),
        "--ckpt-every-s", str(a.ckpt_every_s),
        "--steps", str(a.steps), "--device", a.device,
    ]
    for attempt in range(a.retries):
        try:
            train_main(args)
            break
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 - crash-resume from the checkpoint
            print(f"[tone-stream] run crashed ({type(e).__name__}: {e}); "
                  f"resuming from {ckpt} ({attempt + 1}/{a.retries})")
    else:
        raise SystemExit("tone-stream: out of retries")

    export_best_bundle(out, gen_conf, tok_file, ckpt, bundle_out)
    if not a.skip_final_eval:
        final_test_eval(out, conf, bundle_out, a.device)
    print(f"[tone-stream] done: bundle at {bundle_out}")


def export_best_bundle(out, gen_conf, tok_file, ckpt, bundle_out):
    """Re-export the best-dev-WER checkpoint (<ckpt>_best_wer, written by
    the training CLI at each improvement) as the bundle; the last step's
    bundle moves to model_final.tar.gz. Parameters only: the optimizer
    state is no part of a bundle."""
    best_ckpt = ckpt + "_best_wer"
    if not os.path.isdir(best_ckpt):
        return
    from ..checkpoint import save_bundle
    from ..config import open_config
    from ..convert import export_variables
    from ..data.language import get_language
    from ..models.transducer import Transducer, TransducerConfig
    from ..training.checkpoint import restore_params_only

    conf = open_config(gen_conf)
    # the CLI widens the vocab to the tokenizer's when that is larger
    _, tok_vocab = get_language(model_file=tok_file)
    conf["model"]["vocab_sz"] = max(conf["model"]["vocab_sz"], tok_vocab)
    model = Transducer(TransducerConfig.from_config(conf))
    step = restore_params_only(best_ckpt, model)
    if os.path.exists(bundle_out):
        os.replace(bundle_out, os.path.join(out, "model_final.tar.gz"))
    save_bundle(bundle_out, "en", export_variables(model), conf,
                tokenizer_file=tok_file)
    print(f"[tone-stream] best-dev-WER checkpoint (step {step}) -> {bundle_out}")


def final_test_eval(out, conf, bundle_out, device="cuda"):
    """Greedy WER of the bundle on the held-out test split."""
    from ..api import ASRBundle
    from ..data.synth import ToneStreamDataset
    from ..training.evaluate import evaluate_bundle

    bundle = ASRBundle.from_bundle(bundle_out, extract_to=os.path.join(out, "bundle_x"),
                                   device=device)
    test_ds = ToneStreamDataset.from_config(conf, bundle.lang, "test")
    res = evaluate_bundle(bundle, iter(test_ds), keep_samples=5)
    print(f"[tone-stream] TEST (held-out speakers+sentences): "
          f"wer={res.wer:.3f} cer={res.cer:.3f} n={res.n}")
    for label, rec in res.by_length.items():
        print(f"  WER[{label}] = {rec['wer']:.4f} (n={rec['n']})")
    for s in res.samples:
        print(f"  pred={s['pred']!r} target={s['target']!r}")
    return res


if __name__ == "__main__":
    main()
