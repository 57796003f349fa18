"""Eval LSTM sequence kernels (csrc/lstm_seq.cu, csrc/lstm_seq_int8.cu)
and their plain twins.

Port of the JAX package's Pallas kernels in ops/pallas/lstm.py:
`lstm_seq_pallas` (no lengths: y and the final state) and
`_lstm_seq_pallas_cseq` (also the per-step cell state, for pack
semantics), which hold R in bf16 and accumulate in float32; and
`_lstm_seq_pallas_int8` (int8 R with per-column scales, h quantized per
row each step, int32 accumulation), which serves quantized cells.

`lstm_seq` and `lstm_seq_int8` take their kernel for CUDA tensors and
their plain twins for CPU tensors; a CUDA tensor never falls back.
`LAUNCHES` counts kernel launches so a run can show that its encoder
went through the kernels: the bf16-R kernel is one persistent
cooperative launch per call (per slice of the batch that `fwd_plan`
takes, `batch_slices`), the int8 kernel one launch per timestep.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..quant import QuantizedTensor, int8_matmul
from . import build

KERNEL = "lstm_seq"
KERNEL_INT8 = "lstm_seq_int8"
# launches per wrapper: "lstm_seq" streams only h (kernel A of the JAX
# package), "lstm_seq_cseq" streams h and c (kernel B), "lstm_seq_int8"
# runs the int8 recurrence (kernel C)
LAUNCHES = {"lstm_seq": 0, "lstm_seq_cseq": 0, "lstm_seq_int8": 0}


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


def batch_slices(n: int, plan, *args) -> list[tuple[int, int]]:
    """Contiguous slices (start, rows) of a batch of `n` rows, each the
    largest prefix of what is left that `plan(rows, *args)` plans without
    raising ValueError (a plan that takes a batch takes any smaller one).
    Every row lies in one slice. Raises the plan's own error when not
    even one row fits."""
    plan(1, *args)

    def fits(rows: int) -> bool:
        try:
            plan(rows, *args)
        except ValueError:
            return False
        return True

    lo, hi = 1, n
    while lo < hi:  # the largest size in [1, n] that fits
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    return [(s, min(lo, n - s)) for s in range(0, n, lo)]


# the persistent kernel's launch geometry, as csrc/lstm_seq.cu defines it
SEQ_THREADS = 512
SEQ_MAXC = 8            # (row, unit) pairs an epilogue thread owns
SEQ_MAX_HIDDEN = 8192
MAX_SMEM = 227 * 1024  # per-block shared memory on sm_90 (kernels A/B and E)


@dataclass(frozen=True)
class FwdPlan:
    """The sequence kernel's grid: block b owns hidden units [b * units,
    (b + 1) * units) & [0, hidden) and stages those 4 * units gate
    columns of R, in shared memory when `resident`, else in a global
    scratch read from L2 each step; the warps split K `kw` ways; `smem`
    bytes of shared memory a block; np, kp: the batch and H padded to
    the mma tiles; rstride: the staged columns' row stride."""
    hidden: int
    grid: int
    units: int
    kw: int
    resident: bool
    smem: int
    np: int
    kp: int
    rstride: int

    def units_of(self, block: int) -> range:
        return range(block * self.units, min((block + 1) * self.units, self.hidden))


def _rstride(kp: int) -> int:
    """Row stride of a staged column of R (csrc/lstm_seq.cu's seq_rstride)."""
    return -(-kp // 64) * 64 + 32


def fwd_smem_bytes(n: int, kp: int, units: int, kw: int, resident: bool) -> int:
    """Shared memory of one block (csrc/lstm_seq.cu's seq_smem_bytes):
    the staged columns of R when resident, and the kw K-slices' partial
    products of every 16-row batch tile and 8-column gate tile."""
    red = kw * (-(-n // 16)) * (units // 2) * 128 * 4
    return (4 * units * _rstride(kp) * 2 if resident else 0) + red


def fwd_plan(n: int, hidden: int, sms: int) -> FwdPlan:
    """The sequence kernel's partition of [0, hidden) over at most `sms`
    blocks (one resident block per SM, which the launch checks against
    the occupancy the card reports): the fewest units a block, a multiple
    of 8; R's slice resident in shared memory with the widest K split that
    fits, else read from L2. Raises where the batch is above the
    epilogue's (row, unit) owners (the wrapper then slices the batch)."""
    if hidden > SEQ_MAX_HIDDEN:
        raise ValueError(f"lstm_seq: hidden size {hidden} exceeds the kernel's "
                         f"{SEQ_MAX_HIDDEN}")
    units = -(-(-(-hidden // sms)) // 8) * 8
    grid = -(-hidden // units)
    if n * units > SEQ_MAXC * SEQ_THREADS:
        raise ValueError(f"lstm_seq: batch {n} x {units} units is above the "
                         f"epilogue's {SEQ_MAXC * SEQ_THREADS} pairs")
    kp = -(-hidden // 32) * 32
    for resident in (True, False):
        for kw in (16, 8, 4, 2, 1):
            smem = fwd_smem_bytes(n, kp, units, kw, resident)
            if smem <= MAX_SMEM:
                return FwdPlan(hidden, grid, units, kw, resident, smem,
                               -(-n // 16) * 16, kp, _rstride(kp))
    raise ValueError(f"lstm_seq: batch {n} at hidden size {hidden} needs more "
                     f"than {MAX_SMEM} B of shared memory a block")


def _lib():
    lib = build.load(KERNEL)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lstm_seq_forward.argtypes = [p] * 10 + [i] * 7 + [p]
        lib.lstm_seq_forward.restype = i
        lib.lstm_seq_error_string.argtypes = [i]
        lib.lstm_seq_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(name, x, shape, dtype, device, fn="lstm_seq"):
    if x.device != device:
        raise ValueError(f"{fn}: {name} is on {x.device}, wx on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


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
    rb = r.to(torch.bfloat16).contiguous()
    _check("wx", wx, (n, t, g4), torch.float32, dev)
    _check("r", rb, (h, g4), torch.bfloat16, dev)
    _check("h0", h0, (n, h), torch.float32, dev)
    _check("c0", c0, (n, h), torch.float32, dev)
    sms = build.sm_count(dev.index or 0)
    slices = batch_slices(n, fwd_plan, h, sms)
    lib = _lib()
    y = torch.empty((n, t, h), dtype=torch.float32, device=dev)
    yc = torch.empty_like(y) if stream_c else None
    c_t = None if stream_c else torch.empty((n, h), dtype=torch.float32, device=dev)
    name = "lstm_seq_cseq" if stream_c else "lstm_seq"

    def ptr(x):
        return None if x is None else x.data_ptr()

    # one cooperative launch per slice, each with its own exchange buffer
    # (bf16(h) by step parity; padding rows and columns stay zero) and
    # barrier counter; slices along dim 0 of contiguous tensors are
    # contiguous
    for s0, rows in slices:
        plan = fwd_plan(rows, h, sms)
        part = [None if x is None else x[s0:s0 + rows]
                for x in (wx, h0, c0, y, yc, c_t)]
        xbuf = torch.zeros(2 * plan.np * plan.kp, dtype=torch.bfloat16, device=dev)
        rslice = None if plan.resident else torch.empty(
            plan.grid * 4 * plan.units * plan.rstride, dtype=torch.bfloat16,
            device=dev)
        bar = torch.empty(1, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.lstm_seq_forward(
                ptr(part[0]), ptr(rb), ptr(part[1]), ptr(part[2]), ptr(part[3]),
                ptr(part[4]), ptr(part[5]), ptr(xbuf), ptr(rslice), ptr(bar),
                rows, t, h, plan.grid, plan.units, plan.kw, int(plan.resident),
                stream,
            )
        if rc != 0:
            raise RuntimeError(
                f"lstm_seq kernel failed: {lib.lstm_seq_error_string(rc).decode()}")
        LAUNCHES[name] += 1
    if stream_c:
        return y, yc, y[:, -1], yc[:, -1]
    return y, None, y[:, -1], c_t


def pack_k4(q: torch.Tensor) -> torch.Tensor:
    """int8 [K, O] -> int32 [ceil(K/4), O], the int8 kernel's layout of
    R: word (kk, o) holds q[4kk + i, o] in byte i, K padded with zeros.
    Made once when a quantized cell is bound, never per call."""
    k, o = q.shape
    pad = (-k) % 4
    if pad:
        q = torch.cat([q, q.new_zeros((pad, o))])
    return q.reshape(-1, 4, o).transpose(1, 2).contiguous().view(torch.int32).squeeze(-1)


def lstm_seq_int8_reference(wx, rq, rscale, h0, c0):
    """Plain PyTorch twin of the int8 kernel, the int8 step of the JAX
    scan: h quantized per row in float32 each step, the exact int8
    product of ops.quant.int8_matmul, no bf16 rounding anywhere.

    wx: [N, T, 4H] f32; rq: int8 [H, 4H]; rscale: f32 [1, 4H];
    h0, c0: [N, H] f32. Returns (y, yc), both [N, T, H]."""
    r = QuantizedTensor(rq, rscale)
    h, c = h0.float(), c0.float()
    ys, cs = [], []
    for t in range(wx.shape[1]):
        v = int8_matmul(h, r) + wx[:, t]
        i, g, f, o = v.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
        cs.append(c)
    return torch.stack(ys, dim=1), torch.stack(cs, dim=1)


def _lib_int8():
    lib = build.load(KERNEL_INT8)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lstm_seq_int8_forward.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
        lib.lstm_seq_int8_forward.restype = i
        lib.lstm_seq_int8_error_string.argtypes = [i]
        lib.lstm_seq_int8_error_string.restype = ctypes.c_char_p
        lib.lstm_seq_int8_max_hidden.argtypes = []
        lib.lstm_seq_int8_max_hidden.restype = i
        lib._argtypes_set = True
    return lib


def lstm_seq_int8(wx, rq, rscale, h0, c0, *, rq_packed=None):
    """The int8 LSTM recurrence over T steps from precomputed projections.

    wx: [N, T, 4H] f32; rq: int8 [H, 4H]; rscale: f32 [1, 4H];
    h0, c0: [N, H] f32; rq_packed: `pack_k4(rq)` on the same device,
    required on CUDA. Returns (y, yc), both [N, T, H] f32."""
    if wx.device.type == "cpu":
        return lstm_seq_int8_reference(wx, rq, rscale, h0, c0)
    fn = "lstm_seq_int8"
    if wx.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {wx.device}")
    if wx.dim() != 3 or wx.shape[-1] % 4:
        raise ValueError(f"{fn}: wx must be [N, T, 4H], got {tuple(wx.shape)}")
    n, t, g4 = wx.shape
    h = g4 // 4
    if n == 0 or t == 0:
        raise ValueError(f"{fn}: empty input {tuple(wx.shape)}")
    if rq_packed is None:
        raise ValueError(f"{fn}: needs rq_packed = pack_k4(rq), made once "
                         "when the weights are bound")
    dev = wx.device
    _check("wx", wx, (n, t, g4), torch.float32, dev, fn)
    _check("rq", rq, (h, g4), torch.int8, dev, fn)
    _check("rq_packed", rq_packed, ((h + 3) // 4, g4), torch.int32, dev, fn)
    _check("rscale", rscale, (1, g4), torch.float32, dev, fn)
    _check("h0", h0, (n, h), torch.float32, dev, fn)
    _check("c0", c0, (n, h), torch.float32, dev, fn)
    lib = _lib_int8()
    if h > lib.lstm_seq_int8_max_hidden():
        raise ValueError(f"{fn}: hidden size {h} exceeds the kernel's "
                         f"{lib.lstm_seq_int8_max_hidden()}")
    y = torch.empty((n, t, h), dtype=torch.float32, device=dev)
    yc = torch.empty((n, t, h), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lstm_seq_int8_forward(
            wx.data_ptr(), rq_packed.data_ptr(), rscale.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), y.data_ptr(), yc.data_ptr(),
            n, t, h, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{fn} kernel failed: "
                           f"{lib.lstm_seq_int8_error_string(rc).decode()}")
    LAUNCHES["lstm_seq_int8"] += t
    return y, yc


def lstm_pack(x, state, params, lengths=None):
    """Eval LSTM layer with pack semantics on the sequence kernels
    (the JAX package's lstm_pack_pallas): outputs zeroed past each
    length, returned state frozen at the length, length 0 -> initial
    state; without lengths, the state after step T - 1.

    A quantized recurrent_kernel (ops.quant.QuantizedTensor) runs the
    int8 kernel, else the bf16-R kernel. The input projection runs as
    `int8_matmul` for a quantized kernel, else in float32.

    x: [N, T, I]; state: (h0, c0) [N, H]; params: LSTMParams;
    lengths: [N] integer or None. Returns (y, (h, c))."""
    h0, c0 = (s.float().contiguous() for s in state)
    if isinstance(params.kernel, QuantizedTensor):
        wx = int8_matmul(x, params.kernel) + params.bias
    else:
        wx = x.float() @ params.kernel.float() + params.bias.float()
    wx = wx.contiguous()
    r = params.recurrent_kernel
    if isinstance(r, QuantizedTensor):
        y, yc = lstm_seq_int8(wx, r.q, r.scale, h0, c0, rq_packed=r.packed)
        if lengths is None:
            return y, (y[:, -1], yc[:, -1])
    elif lengths is None:
        y, _, h_t, c_t = lstm_seq(wx, r, h0, c0)
        return y, (h_t, c_t)
    else:
        y, yc, _, _ = lstm_seq(wx, r, h0, c0, stream_c=True)
    return pack_outputs(y, yc, h0, c0, lengths)


def pack_outputs(y, yc, h0, c0, lengths):
    """Pack semantics from the full sequences y, yc [N, T, H]: y zeroed
    past each length, the state read at length - 1 (h0, c0 for length
    0). Plain differentiable operations. Returns (y, (h, c))."""
    t = y.shape[1]
    lengths = lengths.to(y.device)
    valid = torch.arange(t, device=y.device)[None, :] < lengths[:, None]
    y_masked = torch.where(valid[..., None], y, torch.zeros_like(y))
    rows = torch.arange(y.shape[0], device=y.device)
    idx = torch.clamp(lengths - 1, 0, t - 1)
    empty = (lengths == 0)[:, None]
    h_f = torch.where(empty, h0, y[rows, idx])
    c_f = torch.where(empty, c0, yc[rows, idx])
    return y_masked, (h_f, c_f)
