"""Network building blocks as torch.nn modules.

Submodule and parameter names follow the JAX package's flax modules, so
a flax variable path such as `encoder/rnn_stack/layer0/cell/kernel`
is the torch name `encoder.rnn_stack.layer0.cell.kernel` (see
convert.py), and every parameter keeps its JAX layout: Dense kernels
are [in, out], LSTM kernels [I, 4H] in gate order i,g,f,o, GRU/NBRC
kernels [I, 3H] in order z,r,g. A LayerNorm-LSTM cell (an LSTM tower
with `layer_norm`) adds its LN leaves `gamma` [2, 4H], `gamma_h` and
`beta_h` [H] beside them.

Seeded initialisation draws from an explicit torch.Generator on the
CPU, so one seed gives the same weights on every device.

int8-quantized cells hold each matrix as the JAX bundles store it: an
int8 `q` and a float32 `scale` buffer under the matrix's name
(`cell.kernel.q`, `cell.kernel.scale`, ...).

Training mode (`module.train()`) follows the JAX modules' train=True:
batch norms normalise with the masked batch statistics of the valid
frames and update their running statistics; each tower's output
dropout, and the recurrent layers' zoneout and DropConnect masks, draw
from an explicit torch.Generator; recurrent layers never run the eval
kernels (the encoder's LSTM layers train on kernels D and E where JAX
does, else on the differentiable scan cells).
"""

from __future__ import annotations

import math
import sys

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import rnn as rnn_ops
from ..ops.kernels.lstm import lstm_pack, pack_k4
from ..ops.kernels.lstm_train import lstm_pack_train
from ..ops.quant import QuantizedTensor, int8_matmul, quantize
from ..parallel.rows import draw_rows

# shortest sequence the sequence kernel takes; shorter ones (streaming
# chunks, the predictor's single steps) run on the scan cells, as in
# the JAX package
MIN_KERNEL_STEPS = 16
# the JAX package's training LSTM kernels (D, E) take R only up to this
# many bytes in the compute dtype (modules.py:_pallas_train_eligible)
MAX_TRAIN_KERNEL_R_BYTES = 9 * 2**20

_WARNED: set = set()


def _warn_once(key: str, msg: str) -> None:
    """A slower path taken silently costs time without a trace: say so
    once per process, on stderr."""
    if key not in _WARNED:
        _WARNED.add(key)
        print(f"[libreasr_tpu_torch] {msg}", file=sys.stderr)


def dropout(x, rate: float, generator):
    """flax nn.Dropout in training: zero with probability `rate`, scale
    the rest by 1 / (1 - rate); the mask comes from `generator`."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = 1.0 - rate
    u = draw_rows(lambda shape: torch.rand(shape, generator=generator,
                                           device=generator.device), x.shape)
    return torch.where(u.to(x.device) < keep, x / keep, torch.zeros_like(x))


def _xavier_uniform(shape, gen):
    fan_in, fan_out = shape
    a = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * a


def _lecun_normal(shape, gen):
    return torch.randn(shape, generator=gen) / math.sqrt(shape[0])


class Dense(nn.Module):
    """x @ kernel + bias with kernel [in, out]. With `dtype` set, inputs
    and parameters are cast to it and the result stays in it (flax
    Dense(dtype=...))."""

    def __init__(self, in_sz, out_sz, gen, *, use_bias=True, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(_lecun_normal((in_sz, out_sz), gen))
        self.bias = nn.Parameter(torch.zeros(out_sz)) if use_bias else None

    def forward(self, x):
        k, b = self.kernel, self.bias
        if self.dtype is not None:
            x, k = x.to(self.dtype), k.to(self.dtype)
            b = None if b is None else b.to(self.dtype)
        y = x @ k
        return y if b is None else y + b


class LayerNorm(nn.Module):
    """flax nn.LayerNorm: scale and bias, epsilon 1e-6."""

    def __init__(self, feat, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(feat))
        self.bias = nn.Parameter(torch.zeros(feat))

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias,
                            self.eps)


class Embed(nn.Module):
    def __init__(self, vocab_sz, embed_sz, gen):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.randn((vocab_sz, embed_sz), generator=gen) / math.sqrt(embed_sz)
        )

    def forward(self, ids):
        return self.embedding[ids]


class QuantizedWeight(nn.Module):
    """An int8 matrix [I, O]: buffers `q` (int8) and `scale` (float32
    [1, O]). With `packed`, also the LSTM sequence kernel's k-packed
    copy of q, a buffer that is not saved and is remade by `repack`
    whenever q is loaded."""

    def __init__(self, in_sz, out_sz, *, packed=False):
        super().__init__()
        self.register_buffer("q", torch.zeros((in_sz, out_sz), dtype=torch.int8))
        self.register_buffer("scale", torch.ones((1, out_sz)))
        self.register_buffer("packed", pack_k4(self.q) if packed else None,
                             persistent=False)

    def repack(self) -> None:
        if self.packed is not None:
            self.packed = pack_k4(self.q)

    def tensor(self) -> QuantizedTensor:
        return QuantizedTensor(self.q, self.scale, self.packed)


class Cell(nn.Module):
    """The recurrent matrices of one layer in the JAX layout, float32
    parameters or, with `quantized`, int8 QuantizedWeights; a LayerNorm
    LSTM's LN scales and shift stay float32 parameters."""

    def __init__(self, rnn_type, input_sz, hidden_sz, gen, *, quantized=False):
        super().__init__()
        self.rnn_type = rnn_type
        lstm = rnn_type in ("LSTM", "LN_LSTM")
        g = 4 if lstm else 3
        if quantized:
            self.kernel = QuantizedWeight(input_sz, g * hidden_sz)
            self.recurrent_kernel = QuantizedWeight(
                hidden_sz, g * hidden_sz, packed=rnn_type == "LSTM")
        else:
            self.kernel = nn.Parameter(
                _xavier_uniform((input_sz, g * hidden_sz), gen))
            self.recurrent_kernel = nn.Parameter(
                _xavier_uniform((hidden_sz, g * hidden_sz), gen)
            )
        bias = torch.zeros(g * hidden_sz)
        if lstm:
            bias[2 * hidden_sz : 3 * hidden_sz] = 1.0  # forget gate (i,g,f,o)
        self.bias = nn.Parameter(bias)
        if not lstm:
            self.recurrent_bias = nn.Parameter(torch.zeros(g * hidden_sz))
        if rnn_type == "LN_LSTM":
            self.gamma = nn.Parameter(torch.ones(2, g * hidden_sz))
            self.gamma_h = nn.Parameter(torch.ones(hidden_sz))
            self.beta_h = nn.Parameter(torch.zeros(hidden_sz))

    def params(self):
        k, r = (w.tensor() if isinstance(w, QuantizedWeight) else w
                for w in (self.kernel, self.recurrent_kernel))
        if self.rnn_type == "LSTM":
            return rnn_ops.LSTMParams(k, r, self.bias)
        if self.rnn_type == "LN_LSTM":
            return rnn_ops.LayerNormLSTMParams(k, r, self.bias, self.gamma,
                                               self.gamma_h, self.beta_h)
        return rnn_ops.GRUParams(k, r, self.bias, self.recurrent_bias)


class RNNLayer(nn.Module):
    """One recurrent layer with a learnable initial state h0
    [n_state, 1, H].

    Dispatch as in the JAX package (its RNNLayer._pallas_eligible and
    _pallas_train_eligible): in eval, an LSTM in pack mode without
    zoneout over at least MIN_KERNEL_STEPS steps runs on the sequence
    kernel (the int8 one for quantized cells); in training, with
    `use_train_kernel`, such an LSTM whose R in the compute type fits
    MAX_TRAIN_KERNEL_R_BYTES runs on kernels D and E (lstm_pack_train),
    DropConnect's masked R formed outside them; zoneout in training keeps
    the scan cells and says so once; everything else runs on the
    differentiable scan cells. The kernels' wrappers take their plain
    twins for CPU tensors. A LayerNorm LSTM (LN_LSTM) takes the scan
    cells in eval and in training, as in JAX.

    `second_order` (set by a Learner that differentiates twice) makes a
    layer on the D/E route raise: kernels D and E have no double
    backward, and JAX's Pallas training kernels have no JVP either."""

    def __init__(self, input_sz, hidden_sz, gen, *, rnn_type="LSTM",
                 compute_dtype=None, length_mode="pack", use_kernel=False,
                 quantized=False, use_train_kernel=False, zoneout=0.0,
                 dropconnect=0.0):
        super().__init__()
        if rnn_type not in rnn_ops.CELLS:
            raise NotImplementedError(
                f"libreasr_tpu_torch: rnn type {rnn_type!r} is not ported")
        self.hidden_sz = hidden_sz
        self.rnn_type = rnn_type
        self.compute_dtype = compute_dtype
        self.length_mode = length_mode
        self.use_kernel = use_kernel
        self.use_train_kernel = use_train_kernel
        self.zoneout = zoneout
        self.dropconnect = dropconnect
        self.second_order = False
        self.scan, _, self.n_state = rnn_ops.CELLS[rnn_type]
        self.cell = Cell(rnn_type, input_sz, hidden_sz, gen, quantized=quantized)
        self.h0 = nn.Parameter(torch.zeros(self.n_state, 1, hidden_sz))

    def initial_state(self, batch: int):
        return tuple(self.h0[i].expand(batch, self.hidden_sz)
                     for i in range(self.n_state))

    def kernel_eligible(self, x) -> bool:
        return (self.use_kernel and not self.training and self.zoneout == 0.0
                and self.rnn_type == "LSTM" and self.length_mode == "pack"
                and x.shape[1] >= MIN_KERNEL_STEPS)

    def train_kernel_eligible(self, x) -> bool:
        """Where the JAX package trains through its Pallas kernels D/E."""
        if not (self.use_train_kernel and self.training
                and self.rnn_type == "LSTM" and self.length_mode == "pack"):
            return False
        if self.zoneout != 0.0:
            _warn_once(
                "train-kernel-zoneout",
                f"RNNLayer(hidden={self.hidden_sz}): zoneout={self.zoneout} "
                "is not supported by the LSTM training kernels D and E; "
                "training on the slower scan cells (DropConnect is "
                "supported by the kernels)")
            return False
        itemsize = 2 if self.compute_dtype == torch.bfloat16 else 4
        return (x.shape[1] >= MIN_KERNEL_STEPS
                and self.hidden_sz * 4 * self.hidden_sz * itemsize
                <= MAX_TRAIN_KERNEL_R_BYTES
                and not isinstance(self.cell.recurrent_kernel, QuantizedWeight))

    def forward(self, x, state=None, lengths=None, generator=None):
        if state is None:
            state = self.initial_state(x.shape[0])
        params = self.cell.params()
        if self.train_kernel_eligible(x):
            if self.second_order:
                raise ValueError(
                    f"RNNLayer(hidden={self.hidden_sz}): a second-order step "
                    "(AdaHessian's Hutchinson probes) cannot run on the LSTM "
                    "training kernels D and E, which have no double "
                    "backward (nor do the JAX package's Pallas kernels a "
                    "JVP); set encoder.use_pallas_train: false to train "
                    "the encoder on the scan cells")
            if self.dropconnect:
                params = params._replace(recurrent_kernel=rnn_ops.drop_connect(
                    params.recurrent_kernel, self.dropconnect, generator))
            return lstm_pack_train(x, tuple(state), params, lengths,
                                   compute_dtype=self.compute_dtype)
        if self.kernel_eligible(x):
            return lstm_pack(x, tuple(state), params, lengths)
        return self.scan(x, tuple(state), params, lengths=lengths,
                    compute_dtype=self.compute_dtype,
                    length_mode=self.length_mode, zoneout=self.zoneout,
                    dropconnect=self.dropconnect, training=self.training,
                    generator=generator)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over features (the JAX package's MaskedBatchNorm). In
    eval it normalises with the running statistics; in training with the
    batch statistics of the valid frames (t < length), and moves the
    running statistics to m * running + (1 - m) * batch, m = momentum.

    `group` (a process group, set by a data-parallel Learner): the
    batch statistics are those of the global batch, as under JAX's
    GSPMD: the masked sums and counts are all-reduced over the group
    (autograd-aware: the sums' gradients are all-reduced too), so the
    running statistics are equal on every rank. Without a group the module is the single-process one."""

    def __init__(self, feat, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.group = None
        self.scale = nn.Parameter(torch.ones(feat))
        self.bias = nn.Parameter(torch.zeros(feat))
        self.register_buffer("mean", torch.zeros(feat))
        self.register_buffer("var", torch.ones(feat))

    def forward(self, x, lengths=None):
        mean, var = self.mean, self.var
        if self.training:
            xf = x.float()
            if self.group is not None:
                mean, var = self._global_moments(xf, lengths)
            elif lengths is None:
                mean = xf.mean(dim=(0, 1))
                var = xf.var(dim=(0, 1), unbiased=False)
            else:
                mask = (torch.arange(x.shape[1], device=x.device)[None, :]
                        < lengths[:, None]).float()[..., None]
                denom = torch.clamp(mask.sum(), min=1.0)
                mean = (xf * mask).sum(dim=(0, 1)) / denom
                var = ((xf - mean) ** 2 * mask).sum(dim=(0, 1)) / denom
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale + self.bias).to(x.dtype)

    def _global_moments(self, xf, lengths):
        """Mean and (biased) variance of the valid frames of every rank's
        rows: the single-process formulas on all-reduced sums."""
        from ..parallel.collectives import AllReduceSum

        def all_reduce(x, group):
            return AllReduceSum.apply(x, group)

        if lengths is None:
            mask = torch.ones(xf.shape[:2] + (1,), device=xf.device)
        else:
            mask = (torch.arange(xf.shape[1], device=xf.device)[None, :]
                    < lengths[:, None]).float()[..., None]
        denom = torch.clamp(all_reduce(mask.sum(), group=self.group), min=1.0)
        mean = all_reduce((xf * mask).sum(dim=(0, 1)), group=self.group) / denom
        sq = ((xf - mean) ** 2 * mask).sum(dim=(0, 1))
        return mean, all_reduce(sq, group=self.group) / denom


class RNNStack(nn.Module):
    """Layers named layer{i}, each followed by norm{i}; optional time
    reduction before listed layers and a rezero residual. An LSTM stack
    with `layer_norm` has LayerNorm-LSTM cells; `layer_norm` leaves GRU
    and NBRC cells as they are, as in JAX."""

    def __init__(self, input_sz, hidden_sz, num_layers, gen, *,
                 rnn_type="LSTM", layer_norm=False, reduction_indices=(),
                 reduction_factors=(),
                 rezero=False, norm="batch", compute_dtype=None,
                 length_mode="pack", use_kernel=False, quantized=False,
                 use_train_kernel=False, zoneout=0.0, dropconnect=0.0):
        super().__init__()
        self.num_layers = num_layers
        self.reduction = dict(zip(reduction_indices, reduction_factors))
        self.rezero = rezero
        cell_type = "LN_LSTM" if rnn_type == "LSTM" and layer_norm else rnn_type
        in_sz = input_sz
        for i in range(num_layers):
            self.add_module(f"layer{i}", RNNLayer(
                in_sz, hidden_sz, gen, rnn_type=cell_type,
                compute_dtype=compute_dtype, length_mode=length_mode,
                use_kernel=use_kernel, quantized=quantized,
                use_train_kernel=use_train_kernel, zoneout=zoneout,
                dropconnect=dropconnect,
            ))
            if norm == "batch":
                self.add_module(f"norm{i}", MaskedBatchNorm(hidden_sz))
            elif norm == "layer":
                self.add_module(f"norm{i}", LayerNorm(hidden_sz))
            in_sz = hidden_sz

    def layer(self, i) -> RNNLayer:
        return getattr(self, f"layer{i}")

    def forward(self, x, state=None, lengths=None, generator=None):
        residual = None
        new_states = []
        for i in range(self.num_layers):
            if i in self.reduction:
                x, lengths = rnn_ops.time_reduce(x, lengths, self.reduction[i])
            inp = x
            x, st = self.layer(i)(
                x, state=None if state is None else state[i], lengths=lengths,
                generator=generator,
            )
            norm = getattr(self, f"norm{i}", None)
            if isinstance(norm, MaskedBatchNorm):
                x = norm(x, lengths)
            elif norm is not None:
                x = norm(x)
            if self.rezero and residual is not None and residual.shape == x.shape:
                x = x + residual
            residual = inp
            new_states.append(st)
        return x, tuple(new_states)


class Encoder(nn.Module):
    """input LayerNorm -> RNN stack -> dropout (training only) ->
    projection."""

    def __init__(self, feature_sz, hidden_sz, out_sz, gen, *, num_layers=6,
                 rnn_type="LSTM", layer_norm=False, norm="batch",
                 reduction_indices=(),
                 reduction_factors=(), compute_dtype=None, use_kernel=False,
                 quantized=False, dropout=0.0, use_train_kernel=False,
                 zoneout=0.0, dropconnect=0.0):
        super().__init__()
        self.dropout = dropout
        self.input_norm = LayerNorm(feature_sz)
        self.rnn_stack = RNNStack(
            feature_sz, hidden_sz, num_layers, gen, rnn_type=rnn_type,
            layer_norm=layer_norm, norm=norm, reduction_indices=reduction_indices,
            reduction_factors=reduction_factors, compute_dtype=compute_dtype,
            length_mode="haste" if rnn_type == "NBRC" else "pack",
            use_kernel=use_kernel, quantized=quantized,
            use_train_kernel=use_train_kernel, zoneout=zoneout,
            dropconnect=dropconnect,
        )
        self.proj = Dense(hidden_sz, out_sz, gen) if hidden_sz != out_sz else None

    def forward(self, x, state=None, lengths=None, generator=None):
        x = x.reshape(x.shape[0], x.shape[1], -1)
        x = self.input_norm(x)
        x, state = self.rnn_stack(x, state=state, lengths=lengths,
                                  generator=generator)
        if self.training:
            x = dropout(x, self.dropout, generator)
        if self.proj is not None:
            x = self.proj(x)
        return x, state


class Predictor(nn.Module):
    """embed (blank pinned to 0) -> ffn -> RNN stack -> projection."""

    def __init__(self, vocab_sz, embed_sz, hidden_sz, out_sz, gen, *,
                 num_layers=2, blank=0, rnn_type="NBRC", layer_norm=False,
                 norm="batch",
                 compute_dtype=None, quantized=False, dropout=0.0,
                 zoneout=0.0, dropconnect=0.0):
        super().__init__()
        self.blank = blank
        self.dropout = dropout
        self.embed = Embed(vocab_sz, embed_sz, gen)
        self.ffn = Dense(embed_sz, hidden_sz, gen) if embed_sz != hidden_sz else None
        self.rnn_stack = RNNStack(
            hidden_sz, hidden_sz, num_layers, gen, rnn_type=rnn_type,
            layer_norm=layer_norm, norm=norm, compute_dtype=compute_dtype,
            length_mode="haste" if rnn_type == "NBRC" else "pack",
            quantized=quantized, zoneout=zoneout, dropconnect=dropconnect,
        )
        self.proj = Dense(hidden_sz, out_sz, gen) if hidden_sz != out_sz else None

    def forward(self, y, state=None, lengths=None, generator=None):
        emb = self.embed(y)
        emb = torch.where((y == self.blank)[..., None], torch.zeros_like(emb), emb)
        if self.ffn is not None:
            emb = self.ffn(emb)
        x, state = self.rnn_stack(emb, state=state, lengths=lengths,
                                  generator=generator)
        if self.training:
            x = dropout(x, self.dropout, generator)
        if self.proj is not None:
            x = self.proj(x)
        return x, state


class Joint(nn.Module):
    """The joint network, `method` "concat" or "add".

    concat: two projections and a broadcast add,
    tanh(h_pred @ W_p + b + h_enc @ W_e) @ W_out + b_out, so the [.., 2H]
    concat over the [N, T, U] lattice is never built.
    add: tanh((h_pred + h_enc) @ W_p + b) @ W_out + b_out, the sum taken
    first, as JAX's Dense(pred_proj)(h_pred + h_enc); it has no enc_proj."""

    def __init__(self, out_sz, joint_sz, vocab_sz, gen, *, method="concat",
                 compute_dtype=None):
        super().__init__()
        if method not in ("concat", "add"):
            raise ValueError(f"no such joint method: {method}")
        dt = compute_dtype
        self.method = method
        self.pred_proj = Dense(out_sz, joint_sz, gen, dtype=dt)
        if method == "concat":
            self.enc_proj = Dense(out_sz, joint_sz, gen, use_bias=False, dtype=dt)
        self.out = Dense(joint_sz, vocab_sz, gen, dtype=dt)

    def forward(self, h_pred, h_enc):
        if self.method == "add":
            x = self.pred_proj(h_pred + h_enc)
        else:
            x = self.pred_proj(h_pred) + self.enc_proj(h_enc)
        return self.out(torch.tanh(x))

    def int8_step(self):
        """The int8 joint of the JAX package's decoder_fns(quantized=True):
        the three kernels quantized now, at bind time, and run as dynamic
        int8 products (compute_dtype ignored); biases stay float32.
        Returns joint_step(h_pred, h_enc) -> logits. The concat joint
        only: JAX asserts it."""
        if self.method != "concat":
            raise ValueError("the int8 joint needs joint method 'concat' "
                             f"(this one is {self.method!r}), as in JAX")
        q_pred, q_enc, q_out = (quantize(d.kernel) for d in
                                (self.pred_proj, self.enc_proj, self.out))
        b_pred, b_out = self.pred_proj.bias.float(), self.out.bias.float()

        def joint_step(h_pred, h_enc):
            hidden = torch.tanh(int8_matmul(h_pred, q_pred)
                                + int8_matmul(h_enc, q_enc) + b_pred)
            return int8_matmul(hidden, q_out) + b_out

        return joint_step
