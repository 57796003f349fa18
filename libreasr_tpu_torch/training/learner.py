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

Not ported: pipeline parallelism.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from .. import resolve_device
from ..models.modules import RNNLayer
from ..models.transducer import Transducer, TransducerConfig, learnable_states
from ..ops.frontend import FrontendConfig, features_batch
from ..ops.fused_loss import joint_params, rnnt_loss_fused
from ..ops.rnnt_loss import rnnt_loss, rnnt_loss_autodiff
from .optimizers import Transform, apply_updates, build_optimizer, global_norm, make_lr_schedule


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
                 hutchinson: bool = False, pass_loss_value: bool = False):
        if loss_cfg.fused and model.cfg.joint_method != "concat":
            raise ValueError("fused loss requires joint_method='concat'")
        if loss_cfg.fused and hutchinson:
            raise ValueError("fused loss is first-order only (no hutchinson)")
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
        self.params = list(model.parameters())
        self.state = TrainState(step=0, opt_state=tx.init(
            [p.detach() for p in self.params]))
        self.carries: dict[int, BatchCarry] = {}
        self.host_gen = torch.Generator().manual_seed(seed)
        self.gen = torch.Generator(device=self.device).manual_seed(seed + 1)

    @classmethod
    def from_config(cls, conf: dict, *, device=None,
                    seed: int | None = None) -> "Learner":
        """A seeded model of `conf` on `device` (default cuda; raises
        without it), with the config's optimizer, schedule,
        accumulation, frontend and loss."""
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
                   pass_loss_value=plateau)

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
            enc_out, enc_st = self.model.encode(feats, state=enc0, lengths=flens,
                                                generator=self.gen)
            pred_out, pred_st = self.model.predict(
                torch.cat([bos, y], 1), state=pred0, lengths=batch.label_len,
                generator=self.gen)
            return (enc_out, pred_out), (enc_st, pred_st)
        logits, states = self.model(feats, y, flens, batch.label_len,
                                    bos_tokens=bos, enc_state=enc0,
                                    pred_state=pred0, generator=self.gen)
        return logits, states

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
        finite = torch.isfinite(loss)
        for g in grads:
            finite = finite & torch.isfinite(g).all()
        grads = [torch.where(finite, g, torch.zeros_like(g)) for g in grads]
        return grads, finite, hessian_diag

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
        params = [p.detach() for p in self.params]
        updates, opt_state = self.tx.update(grads, self.state.opt_state, params,
                                            **extra)
        apply_updates(params, updates)
        self.state = TrainState(step=self.state.step + 1, opt_state=opt_state)

    def step(self, batch: Batch) -> dict:
        batch = Batch(*(x.to(self.device) for x in batch))
        n = batch.audio.shape[0]
        carry = self.carries.get(n) or init_carry(self.cfg, n, self.device)
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
        return {"loss": loss.detach(), "grad_norm": global_norm(grads),
                "finite": finite, "frames": flens.sum(), "tokens": yl.sum()}

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
