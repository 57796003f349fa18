"""Recurrent cells as plain PyTorch loops over time, differentiable.

Parameter layouts are the JAX package's (haste-compatible), not
nn.LSTM/nn.GRU's:
- LSTM kernel [I, 4H], recurrent_kernel [H, 4H], bias [4H], gates
  i,g,f,o: v = h@R + x@W + b; c' = σ(f)c + σ(i)tanh(g); h' = σ(o)tanh(c')
- GRU/NBRC kernel [I, 3H], recurrent_kernel [H, 3H], bias and
  recurrent_bias [3H], gates z,r,g with the reset applied after the
  matmul: z = σ(Wx_z+Rh_z); r = σ(Wx_r+Rh_r); g = tanh(Wx_g + r·Rh_g);
  h' = z·h + (1-z)·g
- LayerNorm-LSTM (LN_LSTM): the LSTM's gates from LN(Wx; gamma[0]) +
  LN(Rh; gamma[1]) + b, each LN scale-only; then the cell output
  h' = σ(o)tanh(LN(c'; gamma_h, beta_h)), the state keeping c' itself;
  the LNs take the biased variance and eps 1e-5

Length modes: "pack" zeroes outputs and freezes the state past each
length; "haste" keeps every output and reads the returned state off at
each length.

Regularisation, as in the JAX scans (haste's formulas):
- DropConnect (`dropconnect` p, training only): R is masked once per
  call, R * keep / (1 - p) with keep ~ Bernoulli(1 - p) over R's shape;
- zoneout (`zoneout` p) on h: in training h' = (h_new - h) * m + h with
  m ~ Bernoulli(1 - p) drawn per step and element; in eval
  h' = p * h + (1 - p) * h_new.
Masks are drawn from an explicit torch.Generator, or passed in (a test
feeds the ones jax.random draws).

`compute_dtype` (e.g. torch.bfloat16) rounds both matmul operands to
that type and accumulates in float32, as the JAX `_mm` does with
preferred_element_type=float32: the rounded values are widened back to
float32 before the product, which is exact for bf16 operands. A weight
that its owner already holds in the compute type (the streaming
engine's, cast once at build) is taken as it is: on the card its
product runs on the tensor cores, operands in that type with float32
sums and a float32 output (aten::mm.dtype), which is the rounded
product up to the order of the float32 sums; on the CPU it is the
rounded product itself. An int8-quantized weight (ops.quant.
QuantizedTensor) runs the dynamic int8 product `int8_matmul` instead
and ignores `compute_dtype`, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..parallel.rows import draw_rows
from .quant import QuantizedTensor, int8_matmul


class LSTMParams(NamedTuple):
    kernel: torch.Tensor            # [I, 4H]  gates i,g,f,o
    recurrent_kernel: torch.Tensor  # [H, 4H]
    bias: torch.Tensor              # [4H]


class GRUParams(NamedTuple):
    kernel: torch.Tensor            # [I, 3H]  gates z,r,g
    recurrent_kernel: torch.Tensor  # [H, 3H]
    bias: torch.Tensor              # [3H]
    recurrent_bias: torch.Tensor    # [3H]


class LayerNormLSTMParams(NamedTuple):
    kernel: torch.Tensor            # [I, 4H]  gates i,g,f,o
    recurrent_kernel: torch.Tensor  # [H, 4H]
    bias: torch.Tensor              # [4H]
    gamma: torch.Tensor             # [2, 4H]  LN scales of Wx and Rh
    gamma_h: torch.Tensor           # [H]      LN scale of the cell output
    beta_h: torch.Tensor            # [H]      LN shift of the cell output


def round_to(x: torch.Tensor, dtype) -> torch.Tensor:
    """Round to `dtype` and widen back to float32 (identity for None)."""
    return x if dtype is None else x.to(dtype).float()


def _weight(w, compute_dtype):
    """A weight as `_mm` takes it: rounded to the compute type once a
    call; quantized, or already in the compute type, as it is (no
    copy)."""
    if isinstance(w, QuantizedTensor) or w.dtype == compute_dtype:
        return w
    return round_to(w, compute_dtype)


def _mm(a, b, compute_dtype):
    """a @ b for a weight `b` already passed through `_weight`: float32
    `b` (rounded or not) takes a float32 product of the rounded `a`; a
    `b` in the compute type a tensor-core product on the card, float32
    sums and output, and the same rounded product elsewhere."""
    if isinstance(b, QuantizedTensor):
        return int8_matmul(a, b)
    if b.dtype == torch.float32:
        return round_to(a, compute_dtype) @ b
    if b.is_cuda:
        y = torch.mm(a.reshape(-1, a.shape[-1]).to(b.dtype), b,
                     out_dtype=torch.float32)
        return y.reshape(a.shape[:-1] + b.shape[-1:])
    return round_to(a, b.dtype) @ b.float()


def _ln(x, gamma, beta=None, eps: float = 1e-5):
    """LayerNorm over the last axis with the biased variance."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * gamma
    return y if beta is None else y + beta


def _gated(t: int, lengths, new, old):
    """Per-row select: `new` where t < length, else `old`."""
    if lengths is None:
        return new
    return torch.where((t < lengths)[:, None], new, old)


def _bernoulli(keep: float, shape, generator, device):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u < keep).to(device=device, dtype=torch.float32)


def drop_connect(r, p: float, generator=None, mask=None):
    """DropConnect on a recurrent matrix: r * keep / (1 - p), keep drawn
    from `generator` unless `mask` (float or bool, R's shape) is given."""
    if p == 0.0:
        return r
    if mask is None:
        if generator is None:
            raise ValueError("DropConnect in training needs a torch.Generator")
        mask = _bernoulli(1.0 - p, r.shape, generator, r.device)
    return torch.where(mask.bool(), r / (1.0 - p), torch.zeros_like(r))


def _zoneout_masks(p, training, t, n, h, generator, masks, device):
    """[T, N, H] training masks, drawn unless given; None otherwise."""
    if p == 0.0 or not training:
        return None
    if masks is not None:
        return masks.to(device=device, dtype=torch.float32)
    if generator is None:
        raise ValueError("zoneout in training needs a torch.Generator")
    return draw_rows(lambda shape: _bernoulli(1.0 - p, shape, generator, device),
                     (t, n, h), dim=1)


def _zoneout(h_new, h_old, p: float, mask, training: bool):
    if p == 0.0:
        return h_new
    if training:
        return (h_new - h_old) * mask + h_old
    return p * h_old + (1.0 - p) * h_new


def _recurrent(params, x, h, compute_dtype, zoneout, dropconnect, training,
               generator, dropconnect_mask, zoneout_mask):
    """The parts every scan shares: the projection of every step (without
    the bias), R (masked in training when DropConnect is on), and the
    zoneout masks."""
    wx = _mm(x, _weight(params.kernel, compute_dtype), compute_dtype)
    rk = params.recurrent_kernel
    if training and dropconnect:
        rk = drop_connect(rk, dropconnect, generator, dropconnect_mask)
    zm = _zoneout_masks(zoneout, training, x.shape[1], x.shape[0], h.shape[-1],
                        generator, zoneout_mask, x.device)
    return wx, _weight(rk, compute_dtype), zm


def _lstm_steps(x, state, preact, ln_h, zm, *, lengths, length_mode,
                zoneout, training):
    """The LSTM recurrence over T steps, shared by the plain and the
    LayerNorm cell: preact(h, t) gives the gates' pre-activations v,
    ln_h (gamma_h, beta_h) or None normalises c' before the output gate.
    Returns (y [N, T, H], (h, c))."""
    h, c = state
    haste = length_mode == "haste"
    sh, sc = h, c
    ys = []
    for t in range(x.shape[1]):
        i, g, f, o = preact(h, t).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        c_out = c_new if ln_h is None else _ln(c_new, *ln_h)
        h_new = torch.sigmoid(o) * torch.tanh(c_out)
        h_new = _zoneout(h_new, h, zoneout, None if zm is None else zm[t],
                         training)
        if haste:
            sh = _gated(t, lengths, h_new, sh)
            sc = _gated(t, lengths, c_new, sc)
            h, c = h_new, c_new
            ys.append(h_new)
        else:
            ys.append(_gated(t, lengths, h_new, torch.zeros_like(h_new)))
            h = _gated(t, lengths, h_new, h)
            c = _gated(t, lengths, c_new, c)
    y = torch.stack(ys, dim=1)
    return y, ((sh, sc) if haste else (h, c))


def lstm_scan(x, state, params: LSTMParams, *, lengths=None,
              compute_dtype=None, length_mode: str = "pack",
              zoneout: float = 0.0, dropconnect: float = 0.0,
              training: bool = False, generator=None, dropconnect_mask=None,
              zoneout_mask=None):
    """x: [N, T, I]; state: (h, c) each [N, H]; the masks, when given:
    [H, 4H] and [T, N, H]. Returns (y [N, T, H], (h, c))."""
    wx, r, zm = _recurrent(params, x, state[0], compute_dtype, zoneout,
                           dropconnect, training, generator, dropconnect_mask,
                           zoneout_mask)
    # one view a step: the backward of unbind stacks the steps' gradients
    # once, where indexing wx[:, t] would add a zero-filled [N, T, 4H]
    # gradient a step (T times the traffic; most of a long scan's backward)
    wx = (wx + params.bias).unbind(1)
    return _lstm_steps(
        x, state, lambda h, t: _mm(h, r, compute_dtype) + wx[t], None, zm,
        lengths=lengths, length_mode=length_mode, zoneout=zoneout,
        training=training)


def gru_scan(x, state, params: GRUParams, *, lengths=None,
             compute_dtype=None, length_mode: str = "pack",
             zoneout: float = 0.0, dropconnect: float = 0.0,
             training: bool = False, generator=None, dropconnect_mask=None,
             zoneout_mask=None):
    """x: [N, T, I]; state: (h,) [N, H]. Covers GRU and NBRC; the masks
    as for lstm_scan, R's [H, 3H]."""
    (h,) = state
    wx, r, zm = _recurrent(params, x, h, compute_dtype, zoneout, dropconnect,
                           training, generator, dropconnect_mask, zoneout_mask)
    wx = wx + params.bias
    haste = length_mode == "haste"
    sh = h
    ys = []
    for t in range(x.shape[1]):
        rh = _mm(h, r, compute_dtype) + params.recurrent_bias
        wz, wr, wg = wx[:, t].chunk(3, dim=-1)
        rz, rr, rg = rh.chunk(3, dim=-1)
        z = torch.sigmoid(wz + rz)
        rst = torch.sigmoid(wr + rr)
        g = torch.tanh(wg + rst * rg)
        h_new = z * h + (1.0 - z) * g
        h_new = _zoneout(h_new, h, zoneout, None if zm is None else zm[t],
                         training)
        if haste:
            sh = _gated(t, lengths, h_new, sh)
            h = h_new
            ys.append(h_new)
        else:
            ys.append(_gated(t, lengths, h_new, torch.zeros_like(h_new)))
            h = _gated(t, lengths, h_new, h)
    y = torch.stack(ys, dim=1)
    return y, ((sh,) if haste else (h,))


def layernorm_lstm_scan(x, state, params: LayerNormLSTMParams, *,
                        lengths=None, compute_dtype=None,
                        length_mode: str = "pack", zoneout: float = 0.0,
                        dropconnect: float = 0.0, training: bool = False,
                        generator=None, dropconnect_mask=None,
                        zoneout_mask=None):
    """The LayerNorm LSTM; arguments and returns as for lstm_scan."""
    wx, r, zm = _recurrent(params, x, state[0], compute_dtype, zoneout,
                           dropconnect, training, generator, dropconnect_mask,
                           zoneout_mask)
    wx = _ln(wx, params.gamma[0])

    def preact(h, t):
        return _ln(_mm(h, r, compute_dtype), params.gamma[1]) + wx[:, t] + params.bias

    return _lstm_steps(x, state, preact, (params.gamma_h, params.beta_h), zm,
                       lengths=lengths, length_mode=length_mode,
                       zoneout=zoneout, training=training)


def time_reduce(x, lengths, factor: int):
    """Mean-pool time by `factor`: [N, T, H] -> [N, T//factor, H]."""
    n, t, h = x.shape
    t_out = t // factor
    x = x[:, : t_out * factor].reshape(n, t_out, factor, h).mean(dim=2)
    if lengths is not None:
        lengths = lengths // factor
    return x, lengths


def mish(x):
    return x * torch.tanh(F.softplus(x))


# rnn type -> (scan, params type, number of state tensors)
CELLS = {
    "LSTM": (lstm_scan, LSTMParams, 2),
    "GRU": (gru_scan, GRUParams, 1),
    "NBRC": (gru_scan, GRUParams, 1),  # NBRC is haste's GRU under another name
    "LN_LSTM": (layernorm_lstm_scan, LayerNormLSTMParams, 2),
}
