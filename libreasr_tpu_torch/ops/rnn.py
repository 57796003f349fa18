"""Recurrent cells as plain PyTorch loops over time, differentiable.

Parameter layouts are the JAX package's (haste-compatible), not
nn.LSTM/nn.GRU's:
- LSTM kernel [I, 4H], recurrent_kernel [H, 4H], bias [4H], gates
  i,g,f,o: v = h@R + x@W + b; c' = σ(f)c + σ(i)tanh(g); h' = σ(o)tanh(c')
- GRU/NBRC kernel [I, 3H], recurrent_kernel [H, 3H], bias and
  recurrent_bias [3H], gates z,r,g with the reset applied after the
  matmul: z = σ(Wx_z+Rh_z); r = σ(Wx_r+Rh_r); g = tanh(Wx_g + r·Rh_g);
  h' = z·h + (1-z)·g

Length modes: "pack" zeroes outputs and freezes the state past each
length; "haste" keeps every output and reads the returned state off at
each length.

`compute_dtype` (e.g. torch.bfloat16) rounds both matmul operands to
that type and accumulates in float32, as the JAX `_mm` does with
preferred_element_type=float32: the rounded values are widened back to
float32 before the product, which is exact for bf16 operands. An
int8-quantized weight (ops.quant.QuantizedTensor) runs the dynamic int8
product `int8_matmul` instead and ignores `compute_dtype`, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

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


def round_to(x: torch.Tensor, dtype) -> torch.Tensor:
    """Round to `dtype` and widen back to float32 (identity for None)."""
    return x if dtype is None else x.to(dtype).float()


def _weight(w, compute_dtype):
    """A weight as `_mm` takes it: rounded to the compute type once, or
    quantized as it is."""
    return w if isinstance(w, QuantizedTensor) else round_to(w, compute_dtype)


def _mm(a, b, compute_dtype):
    """a @ b for a weight `b` already passed through `_weight`."""
    if isinstance(b, QuantizedTensor):
        return int8_matmul(a, b)
    return round_to(a, compute_dtype) @ b


def _gated(t: int, lengths, new, old):
    """Per-row select: `new` where t < length, else `old`."""
    if lengths is None:
        return new
    return torch.where((t < lengths)[:, None], new, old)


def lstm_scan(x, state, params: LSTMParams, *, lengths=None,
              compute_dtype=None, length_mode: str = "pack"):
    """x: [N, T, I]; state: (h, c) each [N, H].
    Returns (y [N, T, H], (h, c))."""
    h, c = state
    wx = _mm(x, _weight(params.kernel, compute_dtype), compute_dtype) + params.bias
    r = _weight(params.recurrent_kernel, compute_dtype)
    haste = length_mode == "haste"
    sh, sc = h, c
    ys = []
    for t in range(x.shape[1]):
        v = _mm(h, r, compute_dtype) + wx[:, t]
        i, g, f, o = v.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
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


def gru_scan(x, state, params: GRUParams, *, lengths=None,
             compute_dtype=None, length_mode: str = "pack"):
    """x: [N, T, I]; state: (h,) [N, H]. Covers GRU and NBRC."""
    (h,) = state
    wx = _mm(x, _weight(params.kernel, compute_dtype), compute_dtype) + params.bias
    r = _weight(params.recurrent_kernel, compute_dtype)
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
        if haste:
            sh = _gated(t, lengths, h_new, sh)
            h = h_new
            ys.append(h_new)
        else:
            ys.append(_gated(t, lengths, h_new, torch.zeros_like(h_new)))
            h = _gated(t, lengths, h_new, h)
    y = torch.stack(ys, dim=1)
    return y, ((sh,) if haste else (h,))


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


# rnn type -> (params type, number of state tensors)
CELLS = {
    "LSTM": (LSTMParams, 2),
    "GRU": (GRUParams, 1),
    "NBRC": (GRUParams, 1),  # NBRC is haste's GRU under another name
}
