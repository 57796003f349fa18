"""Eval LSTM sequence kernel (csrc/lstm_seq.cu) and its plain twin.

Port of the JAX package's Pallas kernels in ops/pallas/lstm.py:
`lstm_seq_pallas` (no lengths: y and the final state) and
`_lstm_seq_pallas_cseq` (also the per-step cell state, for pack
semantics). Both hold R in bf16 and accumulate in float32.

`lstm_seq` takes the kernel for CUDA tensors and the plain twin
`lstm_seq_reference` for CPU tensors; a CUDA tensor never falls back.
`LAUNCHES` counts kernel launches (one per timestep) so a run can show
that its encoder went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

KERNEL = "lstm_seq"
# launches per wrapper: "lstm_seq" streams only h (kernel A of the JAX
# package), "lstm_seq_cseq" streams h and c (kernel B)
LAUNCHES = {"lstm_seq": 0, "lstm_seq_cseq": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def lstm_seq_reference(wx, r, h0, c0, stream_c: bool):
    """Plain PyTorch twin of the kernel, same numerics: bf16(h) @ bf16(R)
    with float32 accumulation, plus wx[:, t]; gates i,g,f,o.

    wx: [N, T, 4H] f32; r: [H, 4H]; h0, c0: [N, H] f32.
    Returns (y [N, T, H], yc [N, T, H] or None, hT, cT)."""
    rb = r.to(torch.bfloat16).float()
    h, c = h0.float(), c0.float()
    ys, cs = [], []
    for t in range(wx.shape[1]):
        v = h.to(torch.bfloat16).float() @ rb + wx[:, t]
        i, g, f, o = v.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
        if stream_c:
            cs.append(c)
    yc = torch.stack(cs, dim=1) if stream_c else None
    return torch.stack(ys, dim=1), yc, h, c


def _lib():
    lib = build.load(KERNEL)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lstm_seq_forward.argtypes = [p, p, p, p, p, p, p, p, i, i, i, p]
        lib.lstm_seq_forward.restype = i
        lib.lstm_seq_error_string.argtypes = [i]
        lib.lstm_seq_error_string.restype = ctypes.c_char_p
        lib.lstm_seq_max_hidden.argtypes = []
        lib.lstm_seq_max_hidden.restype = i
        lib._argtypes_set = True
    return lib


def _check(name, x, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"lstm_seq: {name} is on {x.device}, wx on {device}")
    if x.dtype != dtype:
        raise TypeError(f"lstm_seq: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"lstm_seq: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"lstm_seq: {name} must be contiguous")


def lstm_seq(wx, r, h0, c0, *, stream_c: bool = False):
    """The LSTM recurrence over T steps from precomputed projections.

    wx: [N, T, 4H] f32; r: [H, 4H] (any float type; held in bf16);
    h0, c0: [N, H] f32. Returns (y [N, T, H], yc [N, T, H] when
    stream_c else None, hT [N, H], cT [N, H])."""
    if wx.device.type == "cpu":
        return lstm_seq_reference(wx, r, h0, c0, stream_c)
    if wx.device.type != "cuda":
        raise ValueError(f"lstm_seq: unsupported device {wx.device}")
    if wx.dim() != 3 or wx.shape[-1] % 4:
        raise ValueError(f"lstm_seq: wx must be [N, T, 4H], got {tuple(wx.shape)}")
    n, t, g4 = wx.shape
    h = g4 // 4
    if n == 0 or t == 0:
        raise ValueError(f"lstm_seq: empty input {tuple(wx.shape)}")
    dev = wx.device
    rb = r.to(torch.bfloat16)
    if not rb.is_contiguous() or rb.data_ptr() % 16:
        rb = rb.contiguous().clone()
    _check("wx", wx, (n, t, g4), torch.float32, dev)
    _check("r", rb, (h, g4), torch.bfloat16, dev)
    _check("h0", h0, (n, h), torch.float32, dev)
    _check("c0", c0, (n, h), torch.float32, dev)
    lib = _lib()
    if h > lib.lstm_seq_max_hidden():
        raise ValueError(f"lstm_seq: hidden size {h} exceeds the kernel's "
                         f"{lib.lstm_seq_max_hidden()}")
    y = torch.empty((n, t, h), dtype=torch.float32, device=dev)
    if stream_c:
        yc = torch.empty((n, t, h), dtype=torch.float32, device=dev)
        cbuf = c_t = None
    else:
        yc = None
        cbuf = torch.empty((2, n, h), dtype=torch.float32, device=dev)
        c_t = torch.empty((n, h), dtype=torch.float32, device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lstm_seq_forward(
            ptr(wx), ptr(rb), ptr(h0), ptr(c0), ptr(y), ptr(yc), ptr(cbuf),
            ptr(c_t), n, t, h, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"lstm_seq kernel failed: {lib.lstm_seq_error_string(rc).decode()}"
        )
    LAUNCHES["lstm_seq_cseq" if stream_c else "lstm_seq"] += t
    if stream_c:
        return y, yc, y[:, -1], yc[:, -1]
    return y, None, y[:, -1], c_t


def lstm_pack(x, state, params, lengths=None):
    """Eval LSTM layer with pack semantics on the sequence kernel
    (the JAX package's lstm_pack_pallas): outputs zeroed past each
    length, returned state frozen at the length, length 0 -> initial
    state. The input projection runs in float32.

    x: [N, T, I]; state: (h0, c0) [N, H]; params: LSTMParams;
    lengths: [N] integer or None. Returns (y, (h, c))."""
    h0, c0 = (s.float().contiguous() for s in state)
    wx = (x.float() @ params.kernel.float() + params.bias.float()).contiguous()
    if lengths is None:
        y, _, h_t, c_t = lstm_seq(wx, params.recurrent_kernel, h0, c0)
        return y, (h_t, c_t)
    y, yc, _, _ = lstm_seq(wx, params.recurrent_kernel, h0, c0, stream_c=True)
    t = x.shape[1]
    lengths = lengths.to(x.device)
    valid = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
    y_masked = torch.where(valid[..., None], y, torch.zeros_like(y))
    rows = torch.arange(x.shape[0], device=x.device)
    idx = torch.clamp(lengths - 1, 0, t - 1)
    empty = (lengths == 0)[:, None]
    h_f = torch.where(empty, h0, y[rows, idx])
    c_f = torch.where(empty, c0, yc[rows, idx])
    return y_masked, (h_f, c_f)
