"""Training LSTM kernels (csrc/lstm_train.cu), their plain twins, and the
differentiable recurrence built on them.

Port of the training section of the JAX package's ops/pallas/lstm.py:
`_train_fwd_call` (kernel D: the recurrence, also streaming the
pre-activations v for the backward), `_train_bwd_call` (kernel E: the
reverse-time backward), the custom-VJP core `lstm_train_core` and
`lstm_pack_train_pallas`, which keeps the input projection and the pack
semantics outside the core as plain differentiable operations.

R comes in the training compute type (bf16 under a bf16 policy, else
float32); h is rounded to it before D's product, and dv before E's, as
in JAX. `lstm_train_fwd` and `lstm_train_bwd` take their kernel for
CUDA tensors and their plain twins for CPU tensors; a CUDA tensor never
falls back. `LAUNCHES` counts kernel launches: D launches once per
timestep; E once per timestep and once more for dh0.
"""

from __future__ import annotations

import ctypes

import torch

from ..rnn import round_to
from . import build
from .lstm import _check, pack_outputs

KERNEL = "lstm_train"
LAUNCHES = {"lstm_train_fwd": 0, "lstm_train_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _round(x, r):
    """x rounded to R's type and widened back (identity for float32 R)."""
    return round_to(x, None if r.dtype == torch.float32 else r.dtype)


def lstm_train_fwd_reference(wx, r, h0, c0):
    """Plain twin of kernel D: v = round(h) @ R + wx[:, t] in float32,
    gates i,g,f,o. Returns (y, c_seq [N, T, H], v [N, T, 4H])."""
    rf = r.float()
    h, c = h0.float(), c0.float()
    ys, cs, vs = [], [], []
    for t in range(wx.shape[1]):
        v = _round(h, r) @ rf + wx[:, t]
        i, g, f, o = v.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
        cs.append(c)
        vs.append(v)
    return torch.stack(ys, 1), torch.stack(cs, 1), torch.stack(vs, 1)


def lstm_train_bwd_reference(dy, dc_in, v, c_seq, cprev, r):
    """Plain twin of kernel E, the reverse-time recurrence of JAX's
    `_lstm_train_bwd_kernel`. Returns (dv [N, T, 4H], dh0, dc0 [N, H])."""
    rf = r.float()
    n, t, g4 = v.shape
    dh_s = v.new_zeros((n, g4 // 4))
    dc_s = v.new_zeros((n, g4 // 4))
    dvs = [None] * t
    for s in reversed(range(t)):
        vi, vg, vf, vo = v[:, s].chunk(4, dim=-1)
        i, g = torch.sigmoid(vi), torch.tanh(vg)
        f, o = torch.sigmoid(vf), torch.sigmoid(vo)
        tc = torch.tanh(c_seq[:, s])
        dh = dy[:, s] + dh_s
        dc = dc_in[:, s] + dc_s + dh * o * (1.0 - tc * tc)
        dv = torch.cat([dc * g * i * (1.0 - i), dc * i * (1.0 - g * g),
                        dc * cprev[:, s] * f * (1.0 - f),
                        dh * tc * o * (1.0 - o)], dim=-1)
        dvs[s] = dv
        dc_s = dc * f
        dh_s = _round(dv, r) @ rf.t()
    return torch.stack(dvs, 1), dh_s, dc_s


def _lib():
    lib = build.load(KERNEL)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lstm_train_forward.argtypes = [p, p, i, p, p, p, p, p, i, i, i, p]
        lib.lstm_train_forward.restype = i
        lib.lstm_train_backward.argtypes = [p, p, p, p, p, p, i, p, p, p,
                                            i, i, i, p]
        lib.lstm_train_backward.restype = i
        lib.lstm_train_error_string.argtypes = [i]
        lib.lstm_train_error_string.restype = ctypes.c_char_p
        lib.lstm_train_max_hidden.argtypes = []
        lib.lstm_train_max_hidden.restype = i
        lib._argtypes_set = True
    return lib


def _prepare(fn, x, r):
    """Checks shared by both wrappers; returns (lib, n, t, h)."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    n, t = x.shape[:2]
    h = r.shape[0]
    if n == 0 or t == 0:
        raise ValueError(f"{fn}: empty input {tuple(x.shape)}")
    if r.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{fn}: R must be bfloat16 or float32, got {r.dtype}")
    _check("r", r, (h, 4 * h), r.dtype, x.device, fn)
    lib = _lib()
    if h > lib.lstm_train_max_hidden():
        raise ValueError(f"{fn}: hidden size {h} exceeds the kernel's "
                         f"{lib.lstm_train_max_hidden()}")
    return lib, n, t, h


def _raise_on(lib, fn, rc):
    if rc != 0:
        raise RuntimeError(f"{fn} kernel failed: "
                           f"{lib.lstm_train_error_string(rc).decode()}")


def lstm_train_fwd(wx, r, h0, c0):
    """Kernel D. wx: [N, T, 4H] f32; r: [H, 4H] bf16 or f32; h0, c0:
    [N, H] f32, all contiguous. Returns (y, c_seq [N, T, H],
    v [N, T, 4H]), float32."""
    if wx.device.type == "cpu":
        return lstm_train_fwd_reference(wx, r, h0, c0)
    fn = "lstm_train_fwd"
    lib, n, t, h = _prepare(fn, wx, r)
    dev = wx.device
    _check("wx", wx, (n, t, 4 * h), torch.float32, dev, fn)
    _check("h0", h0, (n, h), torch.float32, dev, fn)
    _check("c0", c0, (n, h), torch.float32, dev, fn)
    y = torch.empty((n, t, h), dtype=torch.float32, device=dev)
    c_seq = torch.empty_like(y)
    v = torch.empty((n, t, 4 * h), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lstm_train_forward(
            wx.data_ptr(), r.data_ptr(), int(r.dtype == torch.bfloat16),
            h0.data_ptr(), c0.data_ptr(), y.data_ptr(), c_seq.data_ptr(),
            v.data_ptr(), n, t, h, stream)
    _raise_on(lib, fn, rc)
    LAUNCHES[fn] += t
    return y, c_seq, v


def lstm_train_bwd(dy, dc_in, v, c_seq, cprev, r):
    """Kernel E. dy, dc_in, c_seq, cprev: [N, T, H] f32; v: [N, T, 4H]
    f32; r as for `lstm_train_fwd`, all contiguous. Returns
    (dv [N, T, 4H], dh0 [N, H], dc0 [N, H]), float32."""
    if v.device.type == "cpu":
        return lstm_train_bwd_reference(dy, dc_in, v, c_seq, cprev, r)
    fn = "lstm_train_bwd"
    lib, n, t, h = _prepare(fn, v, r)
    dev = v.device
    _check("v", v, (n, t, 4 * h), torch.float32, dev, fn)
    for name, x in (("dy", dy), ("dc_in", dc_in), ("c_seq", c_seq),
                    ("cprev", cprev)):
        _check(name, x, (n, t, h), torch.float32, dev, fn)
    dv = torch.empty_like(v)
    dh0 = torch.empty((n, h), dtype=torch.float32, device=dev)
    dc0 = torch.empty_like(dh0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lstm_train_backward(
            dy.data_ptr(), dc_in.data_ptr(), v.data_ptr(), c_seq.data_ptr(),
            cprev.data_ptr(), r.data_ptr(), int(r.dtype == torch.bfloat16),
            dv.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), n, t, h, stream)
    _raise_on(lib, fn, rc)
    LAUNCHES[fn] += t + 1
    return dv, dh0, dc0


class LSTMTrainCore(torch.autograd.Function):
    """(wx, r, h0, c0) -> (y, c_seq), the recurrence on kernels D and E
    (JAX's `lstm_train_core`). The backward gives dv as wx's gradient
    and dR = h_prev^T dv as one float32 product, rounded to R's type as
    JAX rounds it; an unused output gets a zero cotangent."""

    @staticmethod
    def forward(ctx, wx, r, h0, c0):
        h0f, c0f = h0.float().contiguous(), c0.float().contiguous()
        r = r.contiguous()
        y, c_seq, v = lstm_train_fwd(wx.float().contiguous(), r, h0f, c0f)
        ctx.save_for_backward(v, c_seq, y, h0f, c0f, r)
        ctx.state_dtypes = (h0.dtype, c0.dtype)
        return y, c_seq

    @staticmethod
    def backward(ctx, dy, dc_in):
        v, c_seq, y, h0, c0, r = ctx.saved_tensors
        dy = torch.zeros_like(y) if dy is None else dy.float().contiguous()
        dc_in = (torch.zeros_like(c_seq) if dc_in is None
                 else dc_in.float().contiguous())
        cprev = torch.cat([c0[:, None], c_seq[:, :-1]], 1)
        dv, dh0, dc0 = lstm_train_bwd(dy, dc_in, v, c_seq, cprev, r)
        hprev = torch.cat([h0[:, None], y[:, :-1]], 1)
        n, t, g4 = dv.shape
        dr = hprev.reshape(n * t, -1).t() @ dv.reshape(n * t, g4)
        h_dt, c_dt = ctx.state_dtypes
        return dv, dr.to(r.dtype), dh0.to(h_dt), dc0.to(c_dt)


def lstm_pack_train(x, state, params, lengths=None, *, compute_dtype=None):
    """Training LSTM layer with pack semantics on kernels D and E (the JAX
    package's lstm_pack_train_pallas): forward and gradients of
    ops.rnn.lstm_scan(length_mode="pack") without zoneout. The input
    projection (rounded to the compute type, float32 sums) and the pack
    masking and final-state gather are plain differentiable operations
    around LSTMTrainCore: outputs past a row's length get zero cotangent,
    the gather reads the step the scan freezes at, and a length-0 row
    returns (and routes its gradient to) h0 and c0.

    x: [N, T, I]; state: (h0, c0) [N, H]; params: LSTMParams (a masked R
    for DropConnect is formed by the caller); lengths: [N] or None.
    Returns (y, (h, c))."""
    h0, c0 = state
    if compute_dtype is not None:
        wx = (round_to(x, compute_dtype) @ round_to(params.kernel, compute_dtype)
              + params.bias)
        r = params.recurrent_kernel.to(compute_dtype)
    else:
        wx = x.float() @ params.kernel + params.bias
        r = params.recurrent_kernel
    y, yc = LSTMTrainCore.apply(wx, r, h0, c0)
    if lengths is None:
        return y, (y[:, -1], yc[:, -1])
    return pack_outputs(y, yc, h0, c0, lengths)
