"""LSTM language model (the JAX package's models/lm.py).

Embedding (the blank/pad id 0 gives a zero vector) -> `num_layers` LSTM
layers -> dropout (training mode only) -> output projection, tied to the
embedding when embed_sz == hidden_sz -> log_softmax. The state is an
explicit per-layer (h, c) carry, so that a decoder can step the LM one
token at a time.

The LSTM layers are the port's scan cells (ops/rnn.py:lstm_scan), in
float32 with no compute dtype, as in JAX; the decoders only ever call
the LM at T = 1, so no sequence kernel is involved, and the trainer
(train_lm.py) runs the same scan cells under autograd. Parameter names
are the flax ones (`embed.embedding`, `lstm{i}.kernel`,
`lstm{i}.recurrent_kernel`, `lstm{i}.bias`, `out.kernel`, `out.bias`),
so convert.load_jax_lm_variables maps a JAX LM 1:1.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops import rnn as rnn_ops
from .modules import Cell, Dense, Embed, dropout


@dataclass(frozen=True)
class LMConfig:
    vocab_sz: int = 2048
    embed_sz: int = 1024
    hidden_sz: int = 1024
    num_layers: int = 6
    p: float = 0.2

    @classmethod
    def from_config(cls, conf: dict) -> "LMConfig":
        lm = conf.get("lm", {})
        return cls(
            vocab_sz=lm.get("vocab_sz", 2048),
            embed_sz=lm.get("embed_sz", 1024),
            hidden_sz=lm.get("hidden_sz", 1024),
            num_layers=lm.get("num_layers", 6),
            p=lm.get("p", 0.2),
        )


class LM(nn.Module):
    """Weights are drawn from a CPU torch.Generator seeded with `seed`
    and then moved to `device`. Starts in eval mode."""

    def __init__(self, cfg: LMConfig, *, seed: int = 0, device=None):
        super().__init__()
        self.cfg = c = cfg
        gen = torch.Generator().manual_seed(seed)
        self.embed = Embed(c.vocab_sz, c.embed_sz, gen)
        in_sz = c.embed_sz
        for i in range(c.num_layers):
            self.add_module(f"lstm{i}", Cell("LSTM", in_sz, c.hidden_sz, gen))
            in_sz = c.hidden_sz
        self.out = None if self.tied else Dense(c.hidden_sz, c.vocab_sz, gen)
        self.eval()
        if device is not None:
            self.to(device)

    @property
    def tied(self) -> bool:
        return self.cfg.embed_sz == self.cfg.hidden_sz

    def init_state(self, n: int):
        """Zero (h, c) per layer, [n, hidden] each."""
        dev = self.embed.embedding.device
        return tuple(
            (torch.zeros((n, self.cfg.hidden_sz), device=dev),
             torch.zeros((n, self.cfg.hidden_sz), device=dev))
            for _ in range(self.cfg.num_layers))

    def forward(self, y, state=None, generator=None):
        """y: [N, T] token ids. Returns (log-probs [N, T, V], per-layer
        (h, c)); `state` None starts from zeros. In training mode the
        last LSTM layer's output is dropped out at rate p, with masks
        from `generator`; in eval mode nothing is dropped."""
        x = self.embed(y)
        x = torch.where((y == 0)[..., None], torch.zeros_like(x), x)
        if state is None:
            state = self.init_state(y.shape[0])
        new_states = []
        for i in range(self.cfg.num_layers):
            x, st = rnn_ops.lstm_scan(x, tuple(state[i]),
                                      getattr(self, f"lstm{i}").params())
            new_states.append(st)
        if self.training:
            x = dropout(x, self.cfg.p, generator)
        if self.tied:
            logits = x @ self.embed.embedding.T
        else:
            logits = self.out(x)
        return torch.log_softmax(logits, dim=-1), tuple(new_states)
