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
timestep; E once per slice of the batch (one persistent cooperative
launch for all T steps and dh0, planned by `bwd_plan`; the batch goes in
the largest slices the plan takes, `batch_slices`: a width whose grid
could not be co-resident, or whose slice of R does not fit a block's
shared memory, raises here and is never run another way).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..rnn import round_to
from . import build
from .lstm import MAX_SMEM, _check, batch_slices, pack_outputs

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


# kernel E's launch geometry, as csrc/lstm_train.cu defines it
E_THREADS = 512
E_WARPS = E_THREADS // 32
E_MAXC = 4          # (row, unit) pairs an epilogue thread owns


@dataclass(frozen=True)
class BwdPlan:
    """Kernel E's grid: block b owns hidden units [b * units, (b + 1) *
    units) & [0, hidden) and keeps those rows of R in `smem` bytes of
    shared memory; np, kp: the batch and 4H padded to the mma tiles."""
    hidden: int
    grid: int
    units: int
    smem: int
    np: int
    kp: int

    def units_of(self, block: int) -> range:
        return range(block * self.units, min((block + 1) * self.units, self.hidden))


def bwd_smem_bytes(n: int, kp: int, units: int, r_itemsize: int) -> int:
    """Shared memory of one block of E (csrc/lstm_train.cu's
    bwd_smem_bytes): the R slice, rows padded by 64 B (bf16) or 16 B
    (float32), and the warps' partial products."""
    stride = kp + 32 if r_itemsize == 2 else kp + 4
    red = (E_WARPS * (-(-n // 16)) * (units // 8) * 128 if r_itemsize == 2
           else E_WARPS * n * units)
    return units * stride * r_itemsize + 4 * red


def bwd_plan(n: int, hidden: int, r_itemsize: int, sms: int) -> BwdPlan:
    """Kernel E's partition of [0, hidden) over at most `sms` blocks (one
    resident block per SM, which the launch checks against the occupancy
    the card reports): 8 units a block, or 16 when 8 would need more
    blocks than SMs. Raises where no partition fits."""
    kp = -(-4 * hidden // 32) * 32
    for units in (8, 16):
        grid = -(-hidden // units)
        smem = bwd_smem_bytes(n, kp, units, r_itemsize)
        if smem > MAX_SMEM:
            raise ValueError(
                f"lstm_train_bwd: the slice of R ({units} rows of 4H = "
                f"{4 * hidden}, {r_itemsize}-byte entries) needs {smem} B of "
                f"shared memory, above the block's {MAX_SMEM}")
        if n * units > E_MAXC * E_THREADS:
            raise ValueError(f"lstm_train_bwd: batch {n} x {units} units is "
                             f"above the epilogue's {E_MAXC * E_THREADS} pairs")
        if grid <= sms:
            return BwdPlan(hidden, grid, units, smem, -(-n // 16) * 16, kp)
    raise ValueError(f"lstm_train_bwd: hidden size {hidden} needs more than "
                     f"{sms} co-resident blocks")


def _lib():
    lib = build.load(KERNEL)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lstm_train_forward.argtypes = [p, p, i, p, p, p, p, p, i, i, i, p]
        lib.lstm_train_forward.restype = i
        lib.lstm_train_backward.argtypes = [p, p, p, p, p, p, i, p, p, p, p,
                                            p, i, i, i, i, i, p]
        lib.lstm_train_backward.restype = i
        lib.lstm_train_error_string.argtypes = [i]
        lib.lstm_train_error_string.restype = ctypes.c_char_p
        lib.lstm_train_max_hidden.argtypes = []
        lib.lstm_train_max_hidden.restype = i
        lib._argtypes_set = True
    return lib


def _prepare(fn, x, r):
    """Checks shared by both wrappers; returns (lib, n, t, h); D's width
    limit is checked by its wrapper, E's by its plan."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    n, t = x.shape[:2]
    h = r.shape[0]
    if n == 0 or t == 0:
        raise ValueError(f"{fn}: empty input {tuple(x.shape)}")
    if r.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{fn}: R must be bfloat16 or float32, got {r.dtype}")
    _check("r", r, (h, 4 * h), r.dtype, x.device, fn)
    return _lib(), n, t, h


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
    if h > lib.lstm_train_max_hidden():
        raise ValueError(f"{fn}: hidden size {h} exceeds the kernel's "
                         f"{lib.lstm_train_max_hidden()}")
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
    sms = build.sm_count(dev.index or 0)
    slices = batch_slices(n, bwd_plan, h, r.element_size(), sms)
    bf16 = r.dtype == torch.bfloat16
    dv = torch.empty_like(v)
    dh0 = torch.empty((n, h), dtype=torch.float32, device=dev)
    dc0 = torch.empty_like(dh0)
    # batch rows are independent in this backward: one cooperative launch
    # per slice, each with its own exchange buffer and barrier counter;
    # slices along dim 0 of contiguous tensors are contiguous
    for s0, rows in slices:
        plan = bwd_plan(rows, h, r.element_size(), sms)
        part = [x[s0:s0 + rows] for x in (dy, dc_in, v, c_seq, cprev, dv, dh0, dc0)]
        # r(dv) exchanged between blocks, by step parity (bf16 R; float32
        # R exchanges dv itself); padding rows and columns stay zero
        xbuf = (torch.zeros(2 * plan.np * plan.kp, dtype=torch.bfloat16,
                            device=dev) if bf16 else None)
        bar = torch.empty(1, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.lstm_train_backward(
                *(x.data_ptr() for x in part[:5]), r.data_ptr(), int(bf16),
                *(x.data_ptr() for x in part[5:]),
                xbuf.data_ptr() if xbuf is not None else None, bar.data_ptr(),
                rows, t, h, plan.grid, plan.units, stream)
        _raise_on(lib, fn, rc)
        LAUNCHES[fn] += 1
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
