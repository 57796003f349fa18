"""Int8 quantization for serving (the JAX package's ops/quant.py).

- `quantize(w)`: per-output-channel (last axis) symmetric int8,
  scale = max(absmax / 127, 1e-12), round half to even, clip to ±127;
- `int8_matmul(x, qw)`: dynamic per-row activation quantization, an
  int8 x int8 product accumulated exactly, rescaled to float32 as
  `(acc * x_scale) * w_scale`;
- `quantize_rnn_cells`: the RNN towers' cell matrices of a variables
  dict become QuantizedTensor leaves.

Exactness of the product: the JAX package accumulates int8 x int8 in
int32 and casts to float32. `torch.matmul` takes no integer tensors on
the card, and a float32 product is exact only while every partial sum
stays below 2**24 (127**2 * 1280 is above it). A float64 product of the
int8 values is exact at these sizes (|acc| < 2**53), and its cast to
float32 rounds as int32 -> float32 does, so the result equals JAX's bit
for bit on both devices.

Division: on the card, PyTorch divides a tensor by a Python number as a
product with its reciprocal, which can differ from the quotient in the
last bit. Scales are divided by a 0-d tensor on the same device, which
takes the IEEE quotient, as XLA and the CUDA kernel do.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class QuantizedTensor(NamedTuple):
    q: torch.Tensor       # int8, same shape as the original
    scale: torch.Tensor   # float32 [1, ..., O], per last-axis channel
    # the LSTM sequence kernel's k-packed copy of q (int32
    # [ceil(K/4), O], see ops/kernels/lstm.py:pack_k4), made once when
    # the weights are bound; None where no kernel reads it
    packed: torch.Tensor | None = None


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    """max(absmax / 127, 1e-12) with an IEEE quotient on every device."""
    q = absmax / torch.full((), 127.0, dtype=absmax.dtype, device=absmax.device)
    return torch.clamp(q, min=1e-12)


def quantize(w: torch.Tensor) -> QuantizedTensor:
    """Per-last-axis-channel symmetric int8."""
    w = w.float()
    dims = tuple(range(w.dim() - 1))
    scale = _scale(w.abs().amax(dim=dims, keepdim=True) if dims else w.abs())
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q, scale)


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    return qt.q.float() * qt.scale


def int8_matmul(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Dynamic-quantized matmul: x [.., I] @ w [I, O] -> [.., O] float32."""
    x32 = x.float()
    x_scale = _scale(x32.abs().amax(dim=-1, keepdim=True))
    xq = torch.clamp(torch.round(x32 / x_scale), -127, 127)
    acc = (xq.double() @ qt.q.double()).float()
    return acc * x_scale * qt.scale.reshape(1, -1)


def _in_cell_kernel(path: tuple[str, ...], leaf) -> bool:
    return ("cell" in path and path[-1] in ("kernel", "recurrent_kernel")
            and getattr(leaf, "ndim", 0) == 2)


def quantize_rnn_cells(variables: dict) -> dict:
    """A copy of a nested variables dict of numpy arrays in which every
    2-D `.../cell/kernel` and `.../cell/recurrent_kernel` leaf becomes
    {"q": int8, "scale": float32 [1, O]}: the leaves the JAX package's
    quantize_rnn_cells quantizes, in the layout its bundles store them.
    Every other leaf is passed through."""

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            p = path + (str(k),)
            if isinstance(v, dict):
                out[k] = walk(v, p)
            elif _in_cell_kernel(p, v):
                qt = quantize(torch.from_numpy(np.array(v, np.float32)))
                out[k] = {"q": qt.q.numpy(), "scale": qt.scale.numpy()}
            else:
                out[k] = v
        return out

    return walk(variables, ())


def quantized_bytes(tree: dict) -> tuple[int, int]:
    """(bytes now, bytes if every leaf were float32) of a nested dict of
    numpy arrays."""
    now = full = 0
    for v in tree.values():
        if isinstance(v, dict):
            n, f = quantized_bytes(v)
        else:
            a = np.asarray(v)
            n, f = a.nbytes, a.size * 4
        now, full = now + n, full + f
    return now, full
