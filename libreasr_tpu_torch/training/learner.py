"""Training: the RNN-T train step and the Learner that runs it.

The port of the JAX package's training/learner.py. One step is

    device frontend with SpecAugment -> encoder -> predictor ->
    joint + RNN-T loss -> gradients -> optimizer,

with the loss either fused (ops/fused_loss.py: the joint and the loss
in one autograd function, kernels F, G, H on the card) or over the full
lattice (Transducer.forward, then ops/rnnt_loss.py).

As in JAX:
- the cross-batch carry: with probability use_tmp_state_pcent the
  previous batch's final states (detached) seed the next batch of the
  same size, otherwise the learnable h0, selected inside the
  differentiated graph so that h0 receives gradients;
- tmp-BOS: with probability use_tmp_bos_pcent (when use_tmp_bos) the
  previous batch's last labels replace the BOS column;
- the finite gate: a non-finite loss or gradient zeroes every gradient,
  and the optimizer still steps (its moments and counters advance);
- batch norms update their running statistics in the forward pass.

Random numbers come from two generators the Learner owns: one on the
device for SpecAugment and dropout masks, one on the host for the
per-step carry and tmp-BOS draws (a host draw needs no device sync).
They cannot give jax.random's bits.

AdaHessian (`hutchinson`): the loss is rnnt_loss_autodiff, the gradient
is taken with its graph, and the Hessian-vector product H z with
Rademacher probes z (one per parameter, drawn from the device generator,
or injected by overriding `probes`) is its second backward; the
optimizer gets hessian_diag = z * H z. JAX takes H z as a JVP of the
gradient; both are exact. The fused loss is first-order only, and the
LSTM training kernels D and E have no double backward, so a layer on
that route raises (JAX's Pallas kernels have no JVP either).
`pass_loss_value` hands the loss to the optimizer (reduce_on_plateau).
`step_chained` runs K same-shape steps as K `step` calls in a loop (the
JAX package scans them in one program).

On a mesh (parallel/mesh.py, one process a device) a step equals the
single-process step on the global batch, as JAX's GSPMD program does:
- data: each rank steps on its rows of the global batch. Batch norms
  take the global batch's moments (MaskedBatchNorm.group); every rank
  seeds alike and draws SpecAugment, dropout and zoneout at the global
  batch's shape, keeping its rows (parallel/rows.py); the per-sequence
  losses are gathered, so every rank differentiates the global loss,
  and the gradients are summed over the data group before the finite
  gate, the norm, clipping, accumulation and the optimizer read them.
  Carries hold the rank's rows.
- model: the leaves of JAX's tensor-parallel rule (mesh.leaf_spec) are
  stored as column blocks, with their optimizer moments, and gathered
  whole for the forward (a parametrization), so kernels see whole
  weights; each rank keeps its block of the gradient. Per-tensor
  reductions of the optimizer sum over the model group
  (optimizers.Spread). Storage is split, arithmetic is not.
- pipe: GPipe stages of the encoder's uniform LSTM tail
  (parallel/pipeline.py, PPConfig); the head, predictor, joint and loss
  run on every pipe rank, and the replicated parameters take stage 0's
  gradients.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
from torch.nn.utils import parametrize

from .. import resolve_device
from ..models.modules import MaskedBatchNorm, RNNLayer, dropout
from ..ops import rnn as rnn_ops
from ..parallel.rows import row_scope
from ..models.transducer import Transducer, TransducerConfig, learnable_states
from ..ops.frontend import FrontendConfig, features_batch
from ..ops.fused_loss import joint_params, rnnt_loss_fused
from ..ops.rnnt_loss import rnnt_loss, rnnt_loss_autodiff
from .optimizers import (Spread, Transform, apply_updates, build_optimizer,
                         global_norm, make_lr_schedule)


class Batch(NamedTuple):
    audio: torch.Tensor       # [N, S] padded pcm, or features [N, T, F]
    audio_len: torch.Tensor   # [N]
    labels: torch.Tensor      # [N, U]
    label_len: torch.Tensor   # [N]


class BatchCarry(NamedTuple):
    """Cross-batch caches for one batch size."""

    enc_state: Any
    pred_state: Any
    bos: torch.Tensor   # [N, 1] last labels of the previous batch
    valid: bool         # the carry has been filled once


@dataclass
class TrainState:
    """What the step advances besides the model's own tensors (its
    parameters and batch statistics)."""

    step: int
    opt_state: Any


@dataclass(frozen=True)
class LossConfig:
    zero_nan: bool = True
    div_by_len: bool = False
    keep_best_pcent: float = -0.75
    entropy_loss: bool = False   # + mean lattice entropy
    zero_loss: bool = False      # blank-logit magnitude penalty
    fused: bool = False          # fused joint + loss, no [N, T, U, V] lattice
    t_chunk: int = 16

    @classmethod
    def from_config(cls, conf: dict) -> "LossConfig":
        l = conf.get("loss", {}) or {}
        return cls(
            zero_nan=l.get("zero_nan", True),
            div_by_len=l.get("div_by_len", False),
            keep_best_pcent=l.get("keep_best_pcent", -0.75),
            entropy_loss=l.get("entropy_loss", False),
            zero_loss=l.get("zero_loss", False),
            fused=l.get("fused", False),
            t_chunk=l.get("t_chunk", 16),
        )


@dataclass(frozen=True)
class PPConfig:
    """Pipeline-parallel training (train --pp N): the encoder's uniform
    [H -> H] LSTM layers run GPipe-pipelined over the mesh's pipe axis;
    the input norm and the first n_seq layers (the feature_sz -> H layer
    and any left over when L - 1 does not divide by the stages) run
    before it on every pipe rank. Needs the fused loss and an encoder
    the pipeline expresses exactly (_validate_pp)."""

    mesh: Any
    n_micro: int = 4
    axis: str = "pipe"


def _validate_pp(cfg: TransducerConfig, loss_cfg: LossConfig, pp: PPConfig):
    """JAX's problems and messages, plus the port's own: a model axis
    beside the pipe axis, and DropConnect (JAX's pipeline drops it)."""
    problems = []
    if not loss_cfg.fused:
        problems.append("loss.fused must be true")
    if cfg.enc_rnn_type != "LSTM":
        problems.append(f"encoder rnn_type must be LSTM (got {cfg.enc_rnn_type})")
    if cfg.enc_norm != "none":
        problems.append(
            f"encoder norm must be 'none' (got {cfg.enc_norm!r}: inter-layer "
            "norms would need pipeline stages of their own)")
    if cfg.enc_layer_norm:
        problems.append("LayerNorm-LSTM cells are not pipelined")
    if cfg.zoneout:
        problems.append("zoneout is not pipelined")
    if cfg.dropconnect:
        problems.append("DropConnect is not pipelined")
    if cfg.enc_reduction_indices:
        problems.append("inter-layer time reduction is not pipelined")
    if cfg.use_tmp_state_pcent > 0:
        problems.append(
            "encoder cross-batch state carry (use_tmp_state_pcent) can't "
            "thread through pipeline stages — set it to 0")
    stages = pp.mesh.size(pp.axis)
    if cfg.enc_num_layers - 1 < stages:
        problems.append(
            f"{cfg.enc_num_layers} encoder layers can't fill {stages} stages "
            "(layer 0 is the non-uniform input layer)")
    if pp.mesh.size("model") > 1:
        problems.append("a model axis beside the pipe axis is not supported")
    if problems:
        raise ValueError("pipeline parallelism config: " + "; ".join(problems))


def _pp_split(n_layers: int, stages: int) -> tuple[int, int]:
    """(n_seq, layers per stage): the largest tail divisible by the
    stages is pipelined, the rest runs sequentially."""
    n_pipe = ((n_layers - 1) // stages) * stages
    return n_layers - n_pipe, n_pipe // stages


def init_carry(cfg: TransducerConfig, batch: int, device) -> BatchCarry:
    def zeros_tower(n_layers, rnn_type):
        n_state = 2 if rnn_type == "LSTM" else 1
        return tuple(
            tuple(torch.zeros((batch, cfg.hidden_sz), device=device)
                  for _ in range(n_state))
            for _ in range(n_layers))

    return BatchCarry(
        enc_state=zeros_tower(cfg.enc_num_layers, cfg.enc_rnn_type),
        pred_state=zeros_tower(cfg.pred_num_layers, cfg.pred_rnn_type),
        bos=torch.full((batch, 1), cfg.bos, dtype=torch.long, device=device),
        valid=False,
    )


def _detach(states):
    return tuple(tuple(s.detach() for s in layer) for layer in states)


class Learner:
    """Owns the model in training mode, the optimizer state, the
    per-batch-size carries and the generators. `step(batch)` runs one
    train step and returns its metrics as device tensors."""

    def __init__(self, model: Transducer, tx: Transform,
                 frontend: FrontendConfig | None = None,
                 loss_cfg: LossConfig = LossConfig(), *, seed: int = 0,
                 hutchinson: bool = False, pass_loss_value: bool = False,
                 mesh=None, pp_micro: int = 4):
        """mesh: a mesh over processes (parallel/mesh.py), every rank
        seeded alike; each `step` then takes this rank's rows of the
        global batch. A pipe axis > 1 engages PPConfig."""
        if loss_cfg.fused and model.cfg.joint_method != "concat":
            raise ValueError("fused loss requires joint_method='concat'")
        if loss_cfg.fused and hutchinson:
            raise ValueError("fused loss is first-order only (no hutchinson)")
        self.mesh = mesh
        self.pp = None
        if mesh is not None and mesh.size("pipe") > 1:
            self.pp = PPConfig(mesh=mesh, n_micro=pp_micro)
            _validate_pp(model.cfg, loss_cfg, self.pp)
        if hutchinson and mesh is not None and mesh.size("model") > 1:
            raise ValueError(
                "optimizer adahessian cannot run on a model axis: its "
                "Hutchinson products need every column block of H z")
        self.hutchinson = hutchinson
        self.pass_loss_value = pass_loss_value
        for m in model.modules():
            if isinstance(m, RNNLayer):
                m.second_order = hutchinson
        self.model = model.train()
        self.cfg: TransducerConfig = model.cfg
        self.device = next(model.parameters()).device
        self.tx = tx
        self.frontend = frontend
        self.loss_cfg = loss_cfg
        # the parameters by their single-process names and order; on a
        # mesh each is replicated (None), a column block ("model") or a
        # pipe stage's ("stage")
        self.names = [n for n, _ in model.named_parameters()]
        self.layout = dict.fromkeys(self.names)
        self.owner: dict[str, int] = {}
        self.spread = None
        if mesh is not None:
            self._place(mesh)
        self.held = [n for n in self.names if self.layout[n] != "stage"
                     or self.owner[n] == self._stage]
        self.params = [self.tensor(n) for n in self.held]
        if mesh is not None and (mesh.size("model") > 1 or self.pp):
            self.spread = Spread(
                mesh.group("model"),
                frozenset(i for i, n in enumerate(self.held)
                          if self.layout[n] == "model"),
                mesh.group("pipe"),
                frozenset(i for i, n in enumerate(self.held)
                          if self.layout[n] == "stage"))
        self.state = TrainState(step=0, opt_state=tx.init(
            [p.detach() for p in self.params]))
        self.carries: dict[int, BatchCarry] = {}
        self.host_gen = torch.Generator().manual_seed(seed)
        self.gen = torch.Generator(device=self.device).manual_seed(seed + 1)

    # -- placement on a mesh

    @property
    def _stage(self) -> int:
        return 0 if self.mesh is None else self.mesh.index("pipe")

    def _module_attr(self, name: str):
        mod, _, attr = name.rpartition(".")
        return self.model.get_submodule(mod), attr

    def tensor(self, name: str) -> torch.Tensor:
        """The tensor this rank stores for a parameter (a column block
        for a "model" leaf)."""
        mod, attr = self._module_attr(name)
        if parametrize.is_parametrized(mod, attr):
            return mod.parametrizations[attr].original
        return getattr(mod, attr)

    @torch.no_grad()
    def _place(self, mesh) -> None:
        """Rank 0's values everywhere, batch norms bound to the data
        group, the model axis's column blocks, the pipe stages."""
        from ..parallel.collectives import ColumnShard
        from ..parallel.distributed import replicate_tree
        from ..parallel.mesh import leaf_spec

        if mesh.groups:
            whole = dict(self.model.named_parameters())
            whole.update(self.model.named_buffers())
            got = replicate_tree(mesh, whole, dict.fromkeys(whole))
            for n, t in whole.items():
                t.copy_(got[n])
        if mesh.group("data") is not None:
            for m in self.model.modules():
                if isinstance(m, MaskedBatchNorm):
                    m.group = mesh.group("data")
        if self.pp is not None:
            n_seq, per = _pp_split(self.cfg.enc_num_layers, mesh.size("pipe"))
            for i in range(n_seq, self.cfg.enc_num_layers):
                prefix = f"encoder.rnn_stack.layer{i}."
                for n in self.names:
                    if n.startswith(prefix):
                        self.layout[n] = "stage"
                        self.owner[n] = (i - n_seq) // per
        m_size = mesh.size("model")
        if m_size > 1:
            shapes = {n: p.shape for n, p in self.model.named_parameters()}
            for n in self.names:
                if leaf_spec(n, shapes[n], m_size) == "model":
                    mod, attr = self._module_attr(n)
                    parametrize.register_parametrization(
                        mod, attr, ColumnShard(mesh.group("model"), m_size,
                                               mesh.index("model")),
                        unsafe=True)
                    self.layout[n] = "model"

    # -- whole tensors <-> this rank's parts (checkpoints)

    @torch.no_grad()
    def to_global(self, parts: list) -> list:
        """One tensor a held parameter (its shape, e.g. an optimizer
        moment) -> one whole tensor a parameter of the model, in the
        single-process order: column blocks gathered over the model
        group, stage tensors broadcast from their stage. Collective over
        the mesh; every rank returns the whole list."""
        if self.mesh is None:
            return list(parts)
        from ..parallel.collectives import GatherColumns

        mine = dict(zip(self.held, parts))
        out = []
        for n in self.names:
            kind = self.layout[n]
            if kind == "model":
                out.append(GatherColumns.apply(
                    mine[n], self.mesh.group("model"), self.mesh.size("model"),
                    self.mesh.index("model")))
            elif kind == "stage":
                import torch.distributed as dist

                group = self.mesh.group("pipe")
                buf = mine[n] if n in mine else torch.empty_like(self.tensor(n))
                buf = buf.contiguous()
                dist.broadcast(buf, src=dist.get_process_group_ranks(group)[
                    self.owner[n]], group=group)
                out.append(buf)
            else:
                out.append(mine[n])
        return out

    def to_local(self, whole: list) -> list:
        """The inverse of to_global: this rank's parts of whole tensors
        given in the single-process order."""
        if self.mesh is None:
            return list(whole)
        from ..parallel.distributed import column_block

        by_name = dict(zip(self.names, whole))
        return [column_block(by_name[n], self.mesh.size("model"),
                             self.mesh.index("model"))
                if self.layout[n] == "model" else by_name[n]
                for n in self.held]

    def state_dict(self) -> dict:
        """The model's parameters and batch statistics, whole, under
        the single-process names (collective on a mesh)."""
        whole = self.to_global([p.detach() for p in self.params])
        sd = dict(zip(self.names, whole))
        names = set(self.names)
        sd.update({n: t.detach() for n, t in self.model.state_dict().items()
                   if n not in names and ".parametrizations." not in n})
        return sd

    def _whole_shapes(self) -> dict:
        """{name: shape} of the whole tensors state_dict holds."""
        m = 1 if self.mesh is None else self.mesh.size("model")
        shapes = {}
        for n in self.names:
            shape = tuple(self.tensor(n).shape)
            if self.layout[n] == "model":
                shape = shape[:-1] + (shape[-1] * m,)
            shapes[n] = shape
        shapes.update({n: tuple(b.shape) for n, b in self.model.named_buffers()
                       if ".parametrizations." not in n})
        return shapes

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Load whole tensors (state_dict's layout): each rank keeps its
        parts. Strict, as torch's load_state_dict(strict=True): the keys
        must be state_dict's and every tensor of its whole shape."""
        want = self._whole_shapes()
        missing = sorted(set(want) - set(sd))
        unexpected = sorted(set(sd) - set(want))
        wrong = sorted(n for n in set(want) & set(sd)
                       if tuple(sd[n].shape) != want[n])
        if missing or unexpected or wrong:
            raise RuntimeError(
                "Learner.load_state_dict: missing keys "
                f"{missing}, unexpected keys {unexpected}, shape mismatch for "
                f"{[(n, tuple(sd[n].shape), want[n]) for n in wrong]}")
        for t, v in zip(self.params, self.to_local([sd[n] for n in self.names])):
            t.copy_(v)
        for n, b in self.model.named_buffers():
            if n in want:
                b.copy_(sd[n])

    @classmethod
    def from_config(cls, conf: dict, *, device=None, seed: int | None = None,
                    mesh=None, pp_micro: int = 4) -> "Learner":
        """A seeded model of `conf` on `device` (default cuda; raises
        without it), with the config's optimizer, schedule,
        accumulation, frontend and loss; `mesh` and `pp_micro` as for
        the constructor."""
        device = resolve_device(device)
        seed = conf.get("seed", 42) if seed is None else seed
        model = Transducer(TransducerConfig.from_config(conf), seed=seed,
                           device=device)
        tconf = conf.get("training", {}) or {}
        name = tconf.get("optimizer", "ranger")
        plateau = bool(tconf.get("reduce_on_plateau", False))
        tx = build_optimizer(
            name,
            make_lr_schedule(tconf),
            weight_decay=tconf.get("wd", 0.01),
            grad_clip=tconf.get("grad_clip", 10.0),
            accumulate=conf.get("accumulate_n_batches", 1),
            reduce_on_plateau=plateau,
        )
        return cls(model, tx, FrontendConfig.from_config(conf),
                   LossConfig.from_config(conf), seed=seed,
                   hutchinson=name.lower() == "adahessian",
                   pass_loss_value=plateau, mesh=mesh, pp_micro=pp_micro)

    # -- the parts of one step (separate methods, so a profiler can time them)

    def features(self, batch: Batch):
        if self.frontend is None:
            return batch.audio, batch.audio_len
        return features_batch(batch.audio, batch.audio_len, self.frontend,
                              augment=True, generator=self.gen)

    def _uniform(self) -> float:
        return float(torch.rand((), generator=self.host_gen))

    def forward(self, feats, flens, batch: Batch, carry: BatchCarry):
        """Encoder and predictor (fused loss) or the whole lattice, from
        the carried states or the learnable h0."""
        cfg, n = self.cfg, feats.shape[0]
        use_state = carry.valid and self._uniform() < cfg.use_tmp_state_pcent
        use_bos = (cfg.use_tmp_bos and carry.valid
                   and self._uniform() < cfg.use_tmp_bos_pcent)
        if use_state:
            enc0, pred0 = carry.enc_state, carry.pred_state
        else:
            enc0 = learnable_states(self.model, "encoder", n)
            pred0 = learnable_states(self.model, "predictor", n)
        y = batch.labels.long()
        bos = carry.bos if use_bos else torch.full(
            (n, 1), cfg.bos, dtype=torch.long, device=y.device)
        if self.loss_cfg.fused:
            if self.pp is not None:
                # the pipelined encoder carries no state (utsp is 0)
                enc_out, enc_st = self._encode_pp(feats, flens), enc0
            else:
                enc_out, enc_st = self.model.encode(
                    feats, state=enc0, lengths=flens, generator=self.gen)
            pred_out, pred_st = self.model.predict(
                torch.cat([bos, y], 1), state=pred0, lengths=batch.label_len,
                generator=self.gen)
            return (enc_out, pred_out), (enc_st, pred_st)
        logits, states = self.model(feats, y, flens, batch.label_len,
                                    bos_tokens=bos, enc_state=enc0,
                                    pred_state=pred0, generator=self.gen)
        return logits, states

    def _encode_pp(self, feats, flens):
        """The encoder's math (Encoder.forward) under _validate_pp's
        constraints, its uniform tail pipelined: input LayerNorm, the
        first n_seq layers, the pipeline, dropout, the projection."""
        from ..parallel.pipeline import pipeline_stage

        enc, cfg, pp = self.model.encoder, self.cfg, self.pp
        n, t = feats.shape[0], feats.shape[1]
        x = enc.input_norm(feats.reshape(n, t, -1))
        n_seq, per = _pp_split(cfg.enc_num_layers, pp.mesh.size(pp.axis))
        for i in range(n_seq):
            layer = enc.rnn_stack.layer(i)
            x, _ = rnn_ops.lstm_scan(x, layer.initial_state(n),
                                     layer.cell.params(), lengths=flens,
                                     compute_dtype=cfg.compute_dtype)
        first = n_seq + self._stage * per
        layers = [enc.rnn_stack.layer(i) for i in range(first, first + per)]
        x = pipeline_stage([l.cell.params() for l in layers],
                           [l.h0 for l in layers], x, mesh=pp.mesh,
                           axis=pp.axis, n_micro=pp.n_micro, lengths=flens,
                           compute_dtype=cfg.compute_dtype)
        x = dropout(x, enc.dropout, self.gen)
        return enc.proj(x) if enc.proj is not None else x

    def _data(self):
        """(group, size, index) of the data axis, or None off a mesh (or
        on one without process groups)."""
        if self.mesh is None or self.mesh.group("data") is None:
            return None
        return (self.mesh.group("data"), self.mesh.size("data"),
                self.mesh.index("data"))

    def loss(self, out, flens, batch: Batch):
        cfg, lc = self.cfg, self.loss_cfg
        y, yl = batch.labels.long(), batch.label_len.long()
        flens_red = flens // max(cfg.reduction_factor, 1)
        if lc.fused:
            enc_out, pred_out = out
            per_seq = rnnt_loss_fused(
                enc_out, pred_out, joint_params(self.model.joint), y,
                flens_red, yl, cfg.blank, lc.t_chunk, cfg.compute_dtype)
        else:
            logits = out
            if lc.zero_nan:
                logits = torch.nan_to_num(logits, nan=0.0, posinf=0.0,
                                          neginf=0.0)
            loss_fn = rnnt_loss_autodiff if self.hutchinson else rnnt_loss
            per_seq = loss_fn(logits, y, flens_red, yl, cfg.blank)
            if lc.entropy_loss:
                logp = torch.log_softmax(logits.float(), -1)
                ent = -(logp.exp() * logp).sum(-1)
                per_seq = per_seq + ent.mean(dim=(1, 2))
            if lc.zero_loss:
                zl = (1.0 / (logits[..., 0].abs() + 1e-5)).mean(dim=(1, 2))
                per_seq = per_seq + zl * yl.to(zl.dtype)
        if self._data() is not None:
            # every rank differentiates the global batch's loss
            from ..parallel.collectives import GatherRows

            per_seq = GatherRows.apply(per_seq, *self._data())
            yl = GatherRows.apply(yl, *self._data())
        if lc.div_by_len:
            per_seq = per_seq / (yl.to(per_seq.dtype) + 1e-5)
        if 0.0 <= lc.keep_best_pcent < 1.0:
            k = max(int(per_seq.shape[0] * lc.keep_best_pcent), 1)
            per_seq = torch.topk(per_seq, k).values
        return per_seq.mean()

    def backward(self, loss):
        """Gradients of every parameter (zeros where one is unused), zeroed
        all together unless the loss and every gradient are finite. With
        `hutchinson`, also the Hessian diagonal estimate z * H z (not
        zeroed, as in JAX); else None."""
        grads = torch.autograd.grad(loss, self.params, allow_unused=True,
                                    create_graph=self.hutchinson)
        hessian_diag = self.hessian_diag(grads) if self.hutchinson else None
        grads = [torch.zeros_like(p) if g is None else g.detach()
                 for g, p in zip(grads, self.params)]
        if self.mesh is not None:
            grads, hessian_diag = self._reduce(grads, hessian_diag)
        finite = torch.isfinite(loss)
        for g in grads:
            finite = finite & torch.isfinite(g).all()
        if self.spread is not None:
            # model blocks and pipe stages hold different gradients; on
            # the data axis alone every rank holds the same sums already
            import torch.distributed as dist

            f = finite.to(torch.int32)
            dist.all_reduce(f, op=dist.ReduceOp.MIN)
            finite = f.bool()
        grads = [torch.where(finite, g, torch.zeros_like(g)) for g in grads]
        return grads, finite, hessian_diag

    def _reduce(self, grads, hessian_diag):
        """The global gradient: the replicated parameters take pipe stage
        0's gradients (the head's come from it alone), then every
        gradient is summed over the data group."""
        from ..parallel.collectives import all_reduce_flat, broadcast_flat

        if self.pp is not None:
            import torch.distributed as dist

            group = self.mesh.group(self.pp.axis)
            rep = [i for i, n in enumerate(self.held) if self.layout[n] is None]
            got = broadcast_flat([grads[i] for i in rep],
                                 dist.get_process_group_ranks(group)[0], group)
            for i, g in zip(rep, got):
                grads[i] = g
        if self._data() is not None:
            group = self.mesh.group("data")
            grads = all_reduce_flat(grads, group)
            if hessian_diag is not None:
                hessian_diag = all_reduce_flat(hessian_diag, group)
        return grads, hessian_diag

    def probes(self) -> list:
        """Rademacher probes (+1 or -1), one for each parameter, from the
        device generator (a test injects JAX's by overriding this)."""
        return [torch.randint(0, 2, p.shape, generator=self.gen,
                              device=self.device).float() * 2.0 - 1.0
                for p in self.params]

    def hessian_diag(self, grads) -> list:
        """z * H z from gradients taken with their graph: H z is the
        gradient of <grad, z>, a second backward."""
        z = self.probes()
        live = [i for i, g in enumerate(grads)
                if g is not None and g.requires_grad]
        hz = torch.autograd.grad([grads[i] for i in live], self.params,
                                 grad_outputs=[z[i] for i in live],
                                 allow_unused=True)
        return [zz * (torch.zeros_like(zz) if h is None else h.detach())
                for zz, h in zip(z, hz)]

    def optimize(self, grads, **extra) -> None:
        if self.spread is not None:
            extra["spread"] = self.spread
        params = [p.detach() for p in self.params]
        updates, opt_state = self.tx.update(grads, self.state.opt_state, params,
                                            **extra)
        apply_updates(params, updates)
        self.state = TrainState(step=self.state.step + 1, opt_state=opt_state)

    def step(self, batch: Batch) -> dict:
        batch = Batch(*(x.to(self.device) for x in batch))
        n = batch.audio.shape[0]
        carry = self.carries.get(n) or init_carry(self.cfg, n, self.device)
        with self._scope(n):
            feats, flens = self.features(batch)
            out, (enc_st, pred_st) = self.forward(feats, flens, batch, carry)
            loss = self.loss(out, flens, batch)
        grads, finite, hessian_diag = self.backward(loss)
        extra = {}
        if self.pass_loss_value:
            extra["value"] = loss.detach()
        if hessian_diag is not None:
            extra["hessian_diag"] = hessian_diag
        self.optimize(grads, **extra)
        y, yl = batch.labels.long(), batch.label_len.long()
        last = torch.gather(y, 1, torch.clamp(yl - 1, min=0)[:, None])
        self.carries[n] = BatchCarry(_detach(enc_st), _detach(pred_st), last, True)
        counts = torch.stack([flens.sum(), yl.sum()])
        if self._data() is not None:
            from ..parallel.collectives import all_reduce_flat

            counts = all_reduce_flat([counts], self.mesh.group("data"))[0]
        return {"loss": loss.detach(),
                "grad_norm": global_norm(grads, self.spread),
                "finite": finite, "frames": counts[0], "tokens": counts[1]}

    def _scope(self, n: int):
        """On a mesh: draws at the global batch's shape (this rank's rows
        kept) and each sharded weight gathered once for the step."""
        from contextlib import ExitStack

        stack = ExitStack()
        if self.mesh is not None:
            d = self.mesh.size("data")
            i = self.mesh.index("data")
            stack.enter_context(row_scope(n * d, slice(i * n, (i + 1) * n)))
            if self.mesh.size("model") > 1:
                stack.enter_context(parametrize.cached())
        return stack

    def step_chained(self, batches: list) -> dict:
        """K train steps on batches of one shape (audio and labels), the
        same steps as K `step` calls, generators included. Returns the last
        step's metrics plus `loss_mean`, the chain's mean loss (one batch:
        `step`'s metrics alone, as in JAX)."""
        if len(batches) == 1:
            return self.step(batches[0])
        shape, yshape = batches[0].audio.shape, batches[0].labels.shape
        if any(b.audio.shape != shape or b.labels.shape != yshape
               for b in batches):
            raise ValueError("step_chained needs one bucket shape per chain "
                             "(audio AND label padding)")
        losses = []
        for b in batches:
            metrics = self.step(b)
            losses.append(metrics["loss"])
        return {**metrics, "loss_mean": torch.stack(losses).mean()}
