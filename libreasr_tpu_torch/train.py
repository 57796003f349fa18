"""Training CLI of the port (the JAX package's train.py): builds the data,
the model and the optimizer from a YAML config, trains with periodic
evaluation and best-WER tracking, checkpoints, resumes from its last
checkpoint, and exports a release bundle.

    python -m libreasr_tpu_torch.train --config config/base.yaml \\
        [--lang en] [--steps N] [--ckpt tmp/ckpt] [--bundle-out model.tar.gz] \\
        [--device cuda]

Runs on the card unless `--device cpu` is given. The JAX CLI's CTC
models, pipeline and tensor parallelism, multi-host training and
chained steps are not ported: their flags raise.
"""

from __future__ import annotations

import argparse
import json
import os
import time

# flags of the JAX CLI this port does not implement, with their defaults
_UNPORTED = {"mesh_model": 0, "pp": 0, "pp_micro": 4, "chain_steps": 1,
             "dist_coordinator": "", "dist_procs": 0, "dist_pid": 0,
             "platform": ""}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="config/base.yaml")
    p.add_argument("--lang", default="")
    p.add_argument("--steps", type=int, default=0,
                   help="stop after N steps (0: the config's epochs)")
    p.add_argument("--ckpt", default="tmp/ckpt")
    p.add_argument("--bundle-out", default="")
    p.add_argument("--logdir", default="runs/libreasr")
    p.add_argument("--eval-batches", type=int, default=16)
    p.add_argument("--eval-every", type=int, default=0,
                   help="eval every N steps (0: tests_per_epoch a epoch)")
    p.add_argument("--ckpt-every-s", type=float, default=600.0,
                   help="least seconds between epoch-end checkpoints")
    p.add_argument("--device", default="cuda")
    for name, default in _UNPORTED.items():
        p.add_argument("--" + name.replace("_", "-"), type=type(default),
                       default=default, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for name, default in _UNPORTED.items():
        if getattr(args, name) != default:
            raise NotImplementedError(
                f"libreasr_tpu_torch.train: --{name.replace('_', '-')} is not "
                "ported (ROADMAP)")
    return args


def main(argv=None):
    args = parse_args(argv)

    from . import resolve_device
    from .checkpoint import save_bundle
    from .config import parse_and_apply_config
    from .convert import export_variables
    from .data.batching import ASRDataset
    from .data.language import get_language
    from .training.callbacks import TrainLogger
    from .training.checkpoint import (STATE_FILE, restore_train_state,
                                      save_train_state)
    from .training.learner import Learner

    device = resolve_device(args.device)
    conf = parse_and_apply_config(lang=args.lang, path=args.config)
    if conf["model"].get("name", "Transducer") != "Transducer":
        raise NotImplementedError(
            "libreasr_tpu_torch.train: only the Transducer is ported")
    tok_file = (conf.get("tokenizer", {}) or {}).get("model_file")
    if conf.get("train_tokenizer") and tok_file:
        raise NotImplementedError(
            "libreasr_tpu_torch.train: BPE tokenizer training is not ported")
    use_bpe = bool(tok_file and os.path.exists(tok_file))
    lang, vocab_sz = get_language(model_file=tok_file if use_bpe else None)
    conf["model"]["vocab_sz"] = max(conf["model"]["vocab_sz"], vocab_sz)

    train_ds = ASRDataset.from_config(conf, lang, "train")
    valid_ds = ASRDataset.from_config({**conf, "drop_last": False}, lang, "valid")
    print(f"[train] train={train_ds.builder.stats()} valid={len(valid_ds.builder)}")

    tconf = conf.get("training", {}) or {}
    run_conf = {**conf, "training": {
        **tconf, "total_steps": args.steps or tconf.get("total_steps", 100_000)}}
    learner = Learner.from_config(run_conf, device=device)

    start_step = 0
    if os.path.exists(os.path.join(args.ckpt, STATE_FILE)):
        start_step = restore_train_state(args.ckpt, learner)
        print(f"[train] resumed from {args.ckpt} at step {start_step}")
    logger = TrainLogger(args.logdir)
    _restore_best_wer_bar(logger, args.ckpt, start_step)

    def run_eval(step):
        return _run_eval(learner, lang, valid_ds, logger, step,
                         args.eval_batches, args.ckpt)

    step = _train_loop(args, conf, learner, train_ds, logger, start_step,
                       run_eval)
    save_train_state(os.path.abspath(args.ckpt), learner)
    result = run_eval(step)
    if args.bundle_out:
        save_bundle(args.bundle_out, args.lang or "en",
                    export_variables(learner.model), conf,
                    tokenizer_file=tok_file if use_bpe else None)
        print(f"[train] bundle -> {args.bundle_out}")
    logger.close()
    print(f"[train] done: step={step} wer={result.wer:.3f} cer={result.cer:.3f}")


def _train_loop(args, conf, learner, train_ds, logger, step, run_eval) -> int:
    """Epochs over the training set until --steps (or the config's
    epochs); evaluates every --eval-every steps (default: tests_per_epoch
    times an epoch, counted on the first epoch) and checkpoints at epoch
    ends at most every --ckpt-every-s seconds. Returns the last step."""
    from .training.checkpoint import save_train_state

    if args.steps and step >= args.steps:
        return step
    epochs = 10**9 if args.steps else (conf.get("training") or {}).get("epochs", 20)
    eval_every = args.eval_every if args.eval_every > 0 else None
    t0 = last_save = time.time()
    loss = float("nan")
    for epoch in range(epochs):
        batches = train_ds if eval_every is not None else list(train_ds)
        if eval_every is None:
            eval_every = max(len(batches) // max(conf.get("tests_per_epoch", 8), 1), 1)
        saw_batch = False
        for batch in batches:
            saw_batch = True
            metrics = learner.step(batch)
            prev, step = step, step + 1
            logger.log_step(step, metrics, batch, prev_step=prev)
            if step // eval_every > prev // eval_every:
                run_eval(step)
            if args.steps and step >= args.steps:
                return step
        if not saw_batch:
            raise SystemExit(
                "[train] the loader produced no batch: check the dataset "
                "paths, the bucket ladder and the limits")
        loss = float(metrics["loss"])
        print(f"[train] epoch {epoch} done step={step} loss={loss:.3f} "
              f"({time.time() - t0:.0f}s)", flush=True)
        if time.time() - last_save >= args.ckpt_every_s:
            save_train_state(os.path.abspath(args.ckpt), learner)
            last_save = time.time()
    return step


def _restore_best_wer_bar(logger, ckpt, start_step):
    """A resumed run keeps the best WER from <ckpt>_best_wer.json, so a
    worse eval after the resume cannot replace the best checkpoint."""
    meta = os.path.abspath(ckpt) + "_best_wer.json"
    if not (start_step and ckpt and os.path.exists(meta)):
        return
    with open(meta) as f:
        prev = json.load(f)
    logger.best_wer = float(prev.get("wer", float("inf")))
    print(f"[train] best-WER bar restored: {logger.best_wer:.3f} "
          f"(step {prev.get('step')})")


def _run_eval(learner, lang, valid_ds, logger, step, max_batches, ckpt):
    from .training.checkpoint import save_train_state
    from .training.evaluate import evaluate

    result = evaluate(learner.model, learner.frontend, lang, iter(valid_ds),
                      max_batches=max_batches)
    improved = logger.log_eval(step, result)
    print(f"[eval] step={step} wer={result.wer:.3f} cer={result.cer:.3f} "
          f"align={result.alignment_score:.2f} n={result.n}"
          + (" *best*" if improved else ""), flush=True)
    if improved:
        base = os.path.abspath(ckpt)
        save_train_state(base + "_best_wer", learner)
        with open(base + "_best_wer.json", "w") as f:
            json.dump({"wer": result.wer, "cer": result.cer, "step": step}, f)
    return result


if __name__ == "__main__":
    main()
