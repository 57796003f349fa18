"""Training CLI of the port (the JAX package's train.py): builds the data,
the model and the optimizer from a YAML config, trains with periodic
evaluation and best-WER tracking, checkpoints, resumes from its last
checkpoint, and exports a release bundle.

    python -m libreasr_tpu_torch.train --config config/base.yaml \\
        [--lang en] [--steps N] [--ckpt tmp/ckpt] [--bundle-out model.tar.gz] \\
        [--device cuda] [--platform cpu|gpu|cuda] [--chain-steps K]

Runs on the card unless `--device cpu` (or `--platform cpu`, the JAX
CLI's flag) is given. With `train_tokenizer` set, it first trains the
config's BPE tokenizer on the training labels. `--chain-steps K` buffers
batches of one bucket shape and runs every K of them through
`Learner.step_chained`; a shorter remainder steps singly, and no chain
runs past `--steps`. An adahessian config trains with Hutchinson probes,
and `reduce_on_plateau` feeds the loss to the optimizer. A config with
`model.name: CTCModel` trains the CTC family instead (training/
ctc_learner.py), as the JAX CLI does: epochs up to --steps, a greedy
CTC eval of --eval-batches batches after each, with no checkpoint and
no bundle. The JAX CLI's pipeline and tensor parallelism and multi-host
training are not ported: their flags raise.
"""

from __future__ import annotations

import argparse
import json
import os
import time

# flags of the JAX CLI this port does not implement, with their defaults
_UNPORTED = {"mesh_model": 0, "pp": 0, "pp_micro": 4,
             "dist_coordinator": "", "dist_procs": 0, "dist_pid": 0}
# --platform values (the JAX CLI's jax platform names) -> torch devices
_PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


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
    p.add_argument("--platform", default="",
                   help="cpu, or gpu/cuda for the card (overrides --device)")
    p.add_argument("--chain-steps", type=int, default=1,
                   help="run K same-bucket train steps as one chain")
    for name, default in _UNPORTED.items():
        p.add_argument("--" + name.replace("_", "-"), type=type(default),
                       default=default, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for name, default in _UNPORTED.items():
        if getattr(args, name) != default:
            raise NotImplementedError(
                f"libreasr_tpu_torch.train: --{name.replace('_', '-')} is not "
                "ported (ROADMAP)")
    if args.platform:
        if args.platform.lower() not in _PLATFORMS:
            raise ValueError(f"libreasr_tpu_torch.train: --platform "
                             f"{args.platform!r} is not one of "
                             f"{sorted(_PLATFORMS)}")
        args.device = _PLATFORMS[args.platform.lower()]
    return args


def main(argv=None):
    args = parse_args(argv)

    from . import resolve_device
    from .checkpoint import save_bundle
    from .config import parse_and_apply_config
    from .convert import export_variables
    from .data.batching import ASRDataset
    from .data.builder import ASRDatasetBuilder
    from .data.language import get_language
    from .training.callbacks import TrainLogger
    from .training.checkpoint import (STATE_FILE, restore_train_state,
                                      save_train_state)
    from .training.learner import Learner

    device = resolve_device(args.device)
    conf = parse_and_apply_config(lang=args.lang, path=args.config)
    family = conf["model"].get("name", "Transducer")
    if family not in ("Transducer", "CTCModel"):
        raise ValueError(f"libreasr_tpu_torch.train: unknown model.name {family!r}")
    tok_file = (conf.get("tokenizer", {}) or {}).get("model_file")
    if conf.get("train_tokenizer") and tok_file:
        builder = ASRDatasetBuilder.from_config(conf, "train")
        builder.train_tokenizer(tok_file, conf.get("wanted_vocab_sz", 2048))
    use_bpe = bool(tok_file and os.path.exists(tok_file))
    lang, vocab_sz = get_language(model_file=tok_file if use_bpe else None)
    conf["model"]["vocab_sz"] = max(conf["model"]["vocab_sz"], vocab_sz)

    train_ds = ASRDataset.from_config(conf, lang, "train")
    valid_ds = ASRDataset.from_config({**conf, "drop_last": False}, lang, "valid")
    print(f"[train] train={train_ds.builder.stats()} valid={len(valid_ds.builder)}")
    if family == "CTCModel":
        return _train_ctc(args, conf, lang, train_ds, valid_ds, device)

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
    ends at most every --ckpt-every-s seconds. With --chain-steps K,
    batches wait in one buffer per (audio, label) shape, across epochs,
    until K of them run as one chain; what is left after the last epoch
    steps singly. Returns the last step."""
    from .training.checkpoint import save_train_state

    if args.steps and step >= args.steps:
        return step
    epochs = 10**9 if args.steps else (conf.get("training") or {}).get("epochs", 20)
    eval_every = args.eval_every if args.eval_every > 0 else None
    chain_k = max(args.chain_steps, 1)
    pending: dict = {}
    t0 = last_save = time.time()
    metrics = None

    def run_chunk(chunk) -> bool:
        """Step through `chunk` (cut at --steps): chained when it is K
        long, else singly. True once --steps is reached."""
        nonlocal step, metrics
        if args.steps:
            chunk = chunk[: args.steps - step]
        if chain_k > 1 and len(chunk) == chain_k:
            metrics = learner.step_chained(chunk)
        else:
            for b in chunk:
                metrics = learner.step(b)
        prev, step = step, step + len(chunk)
        logger.log_step(step, metrics, chunk[-1], prev_step=prev)
        if step // eval_every > prev // eval_every:
            run_eval(step)
        return bool(args.steps) and step >= args.steps

    for epoch in range(epochs):
        batches = train_ds if eval_every is not None else list(train_ds)
        if eval_every is None:
            eval_every = max(len(batches) // max(conf.get("tests_per_epoch", 8), 1), 1)
        saw_batch = False
        for batch in batches:
            saw_batch = True
            if chain_k <= 1:
                if run_chunk([batch]):
                    return step
                continue
            key = (tuple(batch.audio.shape), tuple(batch.labels.shape))
            buf = pending.setdefault(key, [])
            buf.append(batch)
            if len(buf) == chain_k:
                pending[key] = []
                if run_chunk(buf):
                    return step
        if not saw_batch:
            raise SystemExit(
                "[train] the loader produced no batch: check the dataset "
                "paths, the bucket ladder and the limits")
        loss = "n/a (no chain filled yet)" if metrics is None else \
            f"{float(metrics['loss']):.3f}"
        print(f"[train] epoch {epoch} done step={step} loss={loss} "
              f"({time.time() - t0:.0f}s)", flush=True)
        if time.time() - last_save >= args.ckpt_every_s:
            save_train_state(os.path.abspath(args.ckpt), learner)
            last_save = time.time()
    for buf in pending.values():
        for b in buf:
            if run_chunk([b]):
                return step
    return step


def _train_ctc(args, conf, lang, train_ds, valid_ds, device):
    """The CTC family: epochs of CTCLearner steps, each followed by a
    greedy CTC eval, until --steps (or the config's epochs)."""
    from .models.ctc import CTCConfig, CTCModel
    from .ops.frontend import FrontendConfig
    from .training.ctc_learner import CTCLearner
    from .training.optimizers import build_optimizer, make_lr_schedule

    tconf = conf.get("training", {}) or {}
    seed = conf.get("seed", 42)
    model = CTCModel(CTCConfig.from_config(conf), seed=seed, device=device)
    schedule = make_lr_schedule(
        {**tconf, "total_steps": args.steps or tconf.get("total_steps", 100_000)})
    tx = build_optimizer(
        tconf.get("optimizer", "adamw"), schedule,
        weight_decay=tconf.get("wd", 0.01),
        grad_clip=tconf.get("grad_clip", 10.0),
        accumulate=conf.get("accumulate_n_batches", 1))
    learner = CTCLearner(model, tx, FrontendConfig.from_config(conf), seed=seed)
    step, metrics, res = 0, None, None
    for epoch in range(tconf.get("epochs", 20)):
        for batch in train_ds:
            metrics = learner.step(batch)
            step += 1
            if args.steps and step >= args.steps:
                break
        if metrics is None:
            raise SystemExit(
                "[train] the loader produced no batch: check the dataset "
                "paths, the bucket ladder and the limits")
        res = learner.evaluate(iter(valid_ds), lang, max_batches=args.eval_batches)
        print(f"[ctc] epoch {epoch} step={step} loss={float(metrics['loss']):.3f} "
              f"wer={res['wer']:.3f} cer={res['cer']:.3f}", flush=True)
        if args.steps and step >= args.steps:
            break
    if res is not None:
        print(f"[train] done: step={step} wer={res['wer']:.3f} cer={res['cer']:.3f}")


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
