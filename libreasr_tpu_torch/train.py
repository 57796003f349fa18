"""Training CLI of the port (the JAX package's train.py): builds the data,
the model and the optimizer from a YAML config, trains with periodic
evaluation and best-WER tracking, checkpoints, resumes from its last
checkpoint, and exports a release bundle.

    python -m libreasr_tpu_torch.train --config config/base.yaml \\
        [--lang en] [--steps N] [--ckpt tmp/ckpt] [--bundle-out model.tar.gz] \\
        [--device cuda] [--platform cpu|gpu|cuda] [--chain-steps K] \\
        [--mesh-model M] [--pp P] [--pp-micro K] \\
        [--dist-coordinator host:port --dist-procs N --dist-pid I]

Several GPUs: one process each, started by torchrun

    torchrun --nproc-per-node N -m libreasr_tpu_torch.train --config ...

or by hand with the --dist-* flags (every process runs the CLI with the
same arguments and its own --dist-pid).

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
no bundle.

With more than one process the run trains on a mesh over them
(parallel/mesh.py; the CTC family takes none, as in JAX): data-parallel
over the processes, with --mesh-model M a model axis and with --pp P
GPipe stages of the encoder (which sets the encoder's norm to "none",
use_tmp_state_pcent to 0 and the fused loss, as the JAX CLI does).
Bucket batch sizes round up to the data axis and ragged last batches
are dropped; each process takes its rows of every global batch; chains
are 1; only rank 0 prints and logs. The run ends with a checkpoint and
the `[train] done (multi-host)` line, without an eval or a bundle (eval
runs in one process on the checkpoint). NCCL on the card, gloo with
--device cpu; a failed NCCL start raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time

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
    p.add_argument("--mesh-model", type=int, default=0,
                   help="model (tensor-parallel) axis size")
    p.add_argument("--pp", type=int, default=0,
                   help="pipeline stages for the encoder's LSTM tail")
    p.add_argument("--pp-micro", type=int, default=4,
                   help="GPipe microbatches per --pp step")
    p.add_argument("--dist-coordinator", default="",
                   help="host:port (or an init URL) of a multi-process run")
    p.add_argument("--dist-procs", type=int, default=0)
    p.add_argument("--dist-pid", type=int, default=0)
    args = p.parse_args(argv)
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

    from .parallel import distributed as dist

    device = resolve_device(args.device)
    if args.dist_coordinator or "WORLD_SIZE" in os.environ:
        dist.initialize(args.dist_coordinator or None, args.dist_procs,
                        args.dist_pid, device=device.type)
        device = dist.local_device(device)
    multiproc, rank0 = dist.process_count() > 1, dist.process_index() == 0
    conf = parse_and_apply_config(lang=args.lang, path=args.config)
    if args.mesh_model:
        conf.setdefault("mesh", {})["model"] = args.mesh_model
    if args.pp > 1:
        conf.setdefault("mesh", {})["pipe"] = args.pp
        # what the pipeline can express exactly (PPConfig)
        conf["model"]["encoder"]["norm"] = "none"
        conf["model"]["encoder"]["use_tmp_state_pcent"] = 0.0
        conf.setdefault("loss", {})["fused"] = True
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

    # the mesh first: batch sizes must divide its data axis
    mesh = None
    if multiproc and family != "CTCModel":
        from .parallel.mesh import mesh_from_config

        mesh = mesh_from_config(conf)
        data_ax = mesh.size("data")
        for b in conf.get("buckets", []) or []:
            if b["bs"] % data_ax:
                b["bs"] = -(-b["bs"] // data_ax) * data_ax
                _say(rank0, f"[train] bucket bs rounded to {b['bs']} "
                     f"(data axis {data_ax})")
        conf["drop_last"] = True  # ragged leftovers don't split
        _say(rank0, f"[train] mesh: {dict(mesh.shape)}")

    train_ds = ASRDataset.from_config(conf, lang, "train")
    valid_ds = ASRDataset.from_config({**conf, "drop_last": False}, lang, "valid")
    _say(rank0, f"[train] train={train_ds.builder.stats()} "
         f"valid={len(valid_ds.builder)}")
    if family == "CTCModel":
        return _train_ctc(args, conf, lang, train_ds, valid_ds, device)

    tconf = conf.get("training", {}) or {}
    run_conf = {**conf, "training": {
        **tconf, "total_steps": args.steps or tconf.get("total_steps", 100_000)}}
    learner = Learner.from_config(run_conf, device=device, mesh=mesh,
                                  pp_micro=args.pp_micro)
    if learner.pp is not None:
        _say(rank0, f"[train] pipeline parallelism: {args.pp} stages x "
             f"{args.pp_micro} microbatches")
    if multiproc:
        _say(rank0, f"[train] multi-host: {dist.process_count()} processes, "
             f"mesh {dict(mesh.shape)}")

    start_step = 0
    if os.path.exists(os.path.join(args.ckpt, STATE_FILE)):
        start_step = restore_train_state(args.ckpt, learner)
        _say(rank0, f"[train] resumed from {args.ckpt} at step {start_step}")
    logger = TrainLogger(args.logdir) if rank0 else None
    if rank0:
        _restore_best_wer_bar(logger, args.ckpt, start_step)

    def run_eval(step):
        return _run_eval(learner, lang, valid_ds, logger, step,
                         args.eval_batches, args.ckpt)

    last: dict = {}
    step = _train_loop(args, conf, learner, train_ds, logger, start_step,
                       run_eval, mesh, last)
    save_train_state(os.path.abspath(args.ckpt), learner)
    if multiproc:
        # eval decodes in one program: leave WER to a single-process run
        # on the checkpoint, as the JAX CLI does
        if rank0:
            logger.close()
            loss = float(last["metrics"]["loss"]) if last else float("nan")
            print(f"[train] done (multi-host): step={step} loss={loss:.3f}")
        return
    result = run_eval(step)
    if args.bundle_out:
        save_bundle(args.bundle_out, args.lang or "en",
                    export_variables(learner.model), conf,
                    tokenizer_file=tok_file if use_bpe else None)
        print(f"[train] bundle -> {args.bundle_out}")
    logger.close()
    print(f"[train] done: step={step} wer={result.wer:.3f} cer={result.cer:.3f}")


def _say(rank0: bool, msg: str) -> None:
    if rank0:
        print(msg, flush=True)


def _train_loop(args, conf, learner, train_ds, logger, step, run_eval,
                mesh=None, last=None) -> int:
    """Epochs over the training set until --steps (or the config's
    epochs); evaluates every --eval-every steps (default: tests_per_epoch
    times an epoch, counted on the first epoch) and checkpoints at epoch
    ends at most every --ckpt-every-s seconds. With --chain-steps K,
    batches wait in one buffer per (audio, label) shape, across epochs,
    until K of them run as one chain; what is left after the last epoch
    steps singly. On a mesh each process steps on its rows of every
    batch, singly, with no eval; rank 0 logs and decides when to
    checkpoint. Returns the last step; `last` (a dict) gets its metrics."""
    from .parallel import distributed as dist
    from .parallel.mesh import shard_batch
    from .training.checkpoint import save_train_state

    metrics = None
    if args.steps and step >= args.steps:
        return step
    epochs = 10**9 if args.steps else (conf.get("training") or {}).get("epochs", 20)
    eval_every = args.eval_every if args.eval_every > 0 else None
    chain_k = max(args.chain_steps, 1) if mesh is None else 1
    rank0 = dist.process_index() == 0
    pending: dict = {}
    t0 = last_save = time.time()

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
                metrics = learner.step(b if mesh is None else dist.global_batch(
                    mesh, shard_batch(mesh, b), learner.device))
        if last is not None:
            last["metrics"] = metrics
        prev, step = step, step + len(chunk)
        if logger is not None:
            logger.log_step(step, metrics, chunk[-1], prev_step=prev)
        if mesh is None and step // eval_every > prev // eval_every:
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
        _say(rank0, f"[train] epoch {epoch} done step={step} loss={loss} "
             f"({time.time() - t0:.0f}s)")
        due = time.time() - last_save >= args.ckpt_every_s
        if mesh is not None:  # every rank joins the collective save or none
            due = dist.rank0_says(due, learner.device)
        if due:
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
