"""RNN-Transducer: encoder, predictor and joint, with the lattice
forward and the decode-facing endpoints of the JAX package's
models/transducer.py. A model starts in eval mode, as the JAX modules
default to train=False; `train()` switches it to the training path
(training/learner.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

from .modules import Encoder, Joint, Predictor


@dataclass(frozen=True)
class TransducerConfig:
    feature_sz: int = 1280
    embed_sz: int = 512
    vocab_sz: int = 2048
    hidden_sz: int = 1024
    out_sz: int = 1024
    joint_sz: int = 1024
    blank: int = 0
    bos: int = 2
    enc_num_layers: int = 6
    enc_rnn_type: str = "LSTM"
    enc_norm: str = "batch"
    enc_reduction_indices: tuple = ()
    enc_reduction_factors: tuple = ()
    # the encoder's LSTM layers run on the sequence kernel (T >= 16)
    enc_use_kernel: bool = True
    # training would run the JAX package's LSTM training kernels D/E,
    # not ported yet: on CUDA that raises (modules.RNNLayer)
    enc_use_train_kernel: bool = True
    enc_dropout: float = 0.05
    pred_num_layers: int = 2
    pred_rnn_type: str = "NBRC"
    pred_norm: str = "batch"
    pred_dropout: float = 0.05
    compute_dtype: Any = None
    # the towers' cell matrices are int8 (a bundle's "quantized_cells")
    quantized_cells: bool = False
    # cross-batch state carry and tmp-BOS probabilities (training)
    use_tmp_state_pcent: float = 0.99
    use_tmp_bos: bool = False
    use_tmp_bos_pcent: float = 0.2

    @property
    def reduction_factor(self) -> int:
        r = 1
        for f in self.enc_reduction_factors:
            r *= f
        return r

    @classmethod
    def from_config(cls, conf: dict) -> "TransducerConfig":
        m = conf["model"]
        enc, pred = m["encoder"], m["predictor"]
        if enc.get("layer_norm") or pred.get("layer_norm"):
            raise NotImplementedError(
                "libreasr_tpu_torch: LayerNorm-LSTM cells are not ported yet")
        if m.get("zoneout", enc.get("zoneout", 0.0)):
            raise NotImplementedError(
                "libreasr_tpu_torch: zoneout is not ported yet (ROADMAP "
                "queue 2, with kernels D and E)")
        if m.get("dropconnect", enc.get("dropconnect", 0.0)):
            raise NotImplementedError(
                "libreasr_tpu_torch: DropConnect is not ported yet (ROADMAP "
                "queue 2, with kernels D and E)")
        if m["joint"]["method"] != "concat":
            raise NotImplementedError(
                "libreasr_tpu_torch: only the concat joint is ported")
        compute = conf.get("dtypes", {}).get("compute")
        return cls(
            feature_sz=m["feature_sz"],
            embed_sz=m["embed_sz"],
            vocab_sz=m["vocab_sz"],
            hidden_sz=m["hidden_sz"],
            out_sz=m["out_sz"],
            joint_sz=m["joint_sz"],
            enc_num_layers=enc["num_layers"],
            enc_rnn_type=enc["rnn_type"],
            enc_norm=enc.get("norm", "batch"),
            enc_reduction_indices=tuple(enc.get("reduction_indices", ())),
            enc_reduction_factors=tuple(enc.get("reduction_factors", ())),
            enc_use_kernel=enc.get("use_pallas", True),
            enc_use_train_kernel=enc.get("use_pallas_train", True),
            enc_dropout=enc.get("dropout", 0.05),
            pred_num_layers=pred["num_layers"],
            pred_rnn_type=pred["rnn_type"],
            pred_norm=pred.get("norm", "batch"),
            pred_dropout=pred.get("dropout", 0.05),
            compute_dtype=torch.bfloat16 if compute == "bfloat16" else None,
            quantized_cells=bool(conf.get("quantized_cells", False)),
            use_tmp_state_pcent=enc.get("use_tmp_state_pcent", 0.99),
            use_tmp_bos=m.get("use_tmp_bos", False),
            use_tmp_bos_pcent=m.get("use_tmp_bos_pcent", 0.2),
        )


class Transducer(nn.Module):
    """Weights are drawn from a CPU torch.Generator seeded with `seed`
    and then moved to `device`."""

    def __init__(self, cfg: TransducerConfig, *, seed: int = 0,
                 device=None):
        super().__init__()
        self.cfg = c = cfg
        gen = torch.Generator().manual_seed(seed)
        self.encoder = Encoder(
            c.feature_sz, c.hidden_sz, c.out_sz, gen,
            num_layers=c.enc_num_layers, rnn_type=c.enc_rnn_type,
            norm=c.enc_norm, reduction_indices=c.enc_reduction_indices,
            reduction_factors=c.enc_reduction_factors,
            compute_dtype=c.compute_dtype, use_kernel=c.enc_use_kernel,
            quantized=c.quantized_cells, dropout=c.enc_dropout,
            use_train_kernel=c.enc_use_train_kernel,
        )
        self.predictor = Predictor(
            c.vocab_sz, c.embed_sz, c.hidden_sz, c.out_sz, gen,
            num_layers=c.pred_num_layers, blank=c.blank,
            rnn_type=c.pred_rnn_type, norm=c.pred_norm,
            compute_dtype=c.compute_dtype, quantized=c.quantized_cells,
            dropout=c.pred_dropout,
        )
        self.joint = Joint(c.out_sz, c.joint_sz, c.vocab_sz, gen,
                           compute_dtype=c.compute_dtype)
        self.eval()
        if device is not None:
            self.to(device)

    def forward(self, x, y, xl=None, yl=None, bos_tokens=None,
                enc_state=None, pred_state=None, generator=None):
        """Lattice forward. x: [N, T, F]; y: [N, U] labels; xl/yl:
        lengths; bos_tokens: optional [N, 1] replacing the BOS column;
        generator: the dropout masks' source in training.
        Returns (logits [N, T, U+1, V], (enc_state, pred_state))."""
        enc_out, enc_state = self.encoder(x, state=enc_state, lengths=xl,
                                          generator=generator)
        if bos_tokens is None:
            bos_tokens = torch.full((y.shape[0], 1), self.cfg.bos,
                                    dtype=y.dtype, device=y.device)
        yconcat = torch.cat([bos_tokens, y], dim=1)
        pred_out, pred_state = self.predictor(yconcat, state=pred_state,
                                              lengths=yl, generator=generator)
        logits = self.joint(pred_out[:, None, :, :].float(),
                            enc_out[:, :, None, :].float())
        return logits, (enc_state, pred_state)

    def encode(self, x, state=None, lengths=None, generator=None):
        return self.encoder(x, state=state, lengths=lengths, generator=generator)

    def predict(self, y, state=None, lengths=None, generator=None):
        return self.predictor(y, state=state, lengths=lengths,
                              generator=generator)

    def joint_step(self, h_pred, h_enc):
        return self.joint(h_pred, h_enc)


def learnable_states(model: Transducer, tower: str, batch: int):
    """A tower's learnable per-layer h0 broadcast to a batch: the initial
    state the model uses when `state=None`."""
    stack = getattr(model, tower).rnn_stack
    return tuple(stack.layer(i).initial_state(batch)
                 for i in range(stack.num_layers))
