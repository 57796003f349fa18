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
went through the kernels: each is one persistent cooperative launch per
call (per slice of the batch that `fwd_plan` takes, `batch_slices`).
`fwd_plan` also plans the training forward D (ops/kernels/lstm_train.py),
which shares the bf16-R kernel's template (csrc/lstm_persistent.cuh).
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


# the persistent kernels' launch geometry, as csrc/lstm_persistent.cuh
# defines it (kernels B, C and D; E shares the block size)
SEQ_THREADS = 512
SEQ_MAXC = 8            # (row, unit) pairs an epilogue thread owns
SEQ_MAX_HIDDEN = 8192
MAX_SMEM = 227 * 1024  # per-block shared memory on sm_90 (kernels A-E)
# what the plan calls each R entry size: 2 bf16 (A/B, D), 4 float32 (D),
# 1 int8 (C)
_KIND = {2: "bf16 R", 4: "float32 R", 1: "int8 R"}


@dataclass(frozen=True)
class FwdPlan:
    """A persistent forward's grid (kernels A/B, C and D): block b owns
    hidden units [b * units, (b + 1) * units) & [0, hidden) and stages
    those 4 * units gate columns of R, in shared memory when `resident`,
    else in a global scratch read from L2 each step; the warps split K
    `kw` ways; `smem` bytes of shared memory a block; np, kp: the batch
    and H padded to the product's tiles; rstride: the staged columns'
    row stride (bf16 or float32 entries, or int32 words of 4 int8 k)."""
    hidden: int
    grid: int
    units: int
    kw: int
    resident: bool
    smem: int
    np: int
    kp: int
    rstride: int
    r_itemsize: int = 2

    def units_of(self, block: int) -> range:
        return range(block * self.units, min((block + 1) * self.units, self.hidden))


def _kpad(hidden: int, r_itemsize: int = 2) -> int:
    """H padded to the product's k granule (csrc/lstm_persistent.cuh's
    fwd_kpad): 64 for int8's m16n8k32 pairs, else 32."""
    g = 64 if r_itemsize == 1 else 32
    return -(-hidden // g) * g


def _rstride(kp: int, r_itemsize: int = 2) -> int:
    """Row stride of a staged column of R (fwd_rstride): bf16 entries
    (kp rounded up to 64, plus 32), float32 entries (kp + 4) or int32
    words of 4 int8 k (kp / 4 rounded up to 32, plus 16)."""
    if r_itemsize == 2:
        return -(-kp // 64) * 64 + 32
    if r_itemsize == 4:
        return kp + 4
    return -(-(kp // 4) // 32) * 32 + 16


def fwd_smem_bytes(n: int, kp: int, units: int, kw: int, resident: bool,
                   r_itemsize: int = 2) -> int:
    """Shared memory of one block (fwd_smem_bytes): the staged columns of
    R when resident; the kw K-slices' partial products (float32 R: one
    per (row, column) pair; bf16 and int8: the mma accumulators of every
    16-row batch tile and 8-column gate tile); for int8 the rows' scales,
    their reciprocals and the block's maxima of |h|."""
    cols, np_ = 4 * units, -(-n // 16) * 16
    entry = 2 if r_itemsize == 2 else 4
    rs = cols * _rstride(kp, r_itemsize) * entry if resident else 0
    red = (kw * n * cols * 4 if r_itemsize == 4
           else kw * (np_ // 16) * (units // 2) * 128 * 4)
    scales = 3 * np_ * 4 if r_itemsize == 1 else 0
    return rs + red + scales


def fwd_plan(n: int, hidden: int, sms: int, r_itemsize: int = 2) -> FwdPlan:
    """A persistent forward's partition of [0, hidden) over at most `sms`
    blocks (one resident block per SM, which the launch checks against
    the occupancy the card reports): the fewest units a block, a multiple
    of 8; R's slice resident in shared memory with the widest K split that
    fits, else read from L2. `r_itemsize`: 2 (bf16 R: A/B, D), 4 (float32
    R: D) or 1 (int8 R: C). Raises where the batch is above the
    epilogue's (row, unit) owners (the wrapper then slices the batch)."""
    kind = _KIND[r_itemsize]
    if hidden > SEQ_MAX_HIDDEN:
        raise ValueError(f"lstm forward ({kind}): hidden size {hidden} exceeds "
                         f"the kernel's {SEQ_MAX_HIDDEN}")
    units = -(-(-(-hidden // sms)) // 8) * 8
    grid = -(-hidden // units)
    if n * units > SEQ_MAXC * SEQ_THREADS:
        raise ValueError(f"lstm forward ({kind}): batch {n} x {units} units is "
                         f"above the epilogue's {SEQ_MAXC * SEQ_THREADS} pairs")
    kp = _kpad(hidden, r_itemsize)
    for resident in (True, False):
        for kw in (16, 8, 4, 2, 1):
            smem = fwd_smem_bytes(n, kp, units, kw, resident, r_itemsize)
            if smem <= MAX_SMEM:
                return FwdPlan(hidden, grid, units, kw, resident, smem,
                               -(-n // 16) * 16, kp, _rstride(kp, r_itemsize),
                               r_itemsize)
    raise ValueError(f"lstm forward ({kind}): batch {n} at hidden size {hidden} "
                     f"needs more than {MAX_SMEM} B of shared memory a block")


def rslice_scratch(plan: FwdPlan, dtype, device):
    """The L2 variant's global copy of each block's R slice, or None when
    the slice is resident in shared memory."""
    if plan.resident:
        return None
    return torch.empty(plan.grid * 4 * plan.units * plan.rstride, dtype=dtype,
                       device=device)


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
        rslice = rslice_scratch(plan, torch.bfloat16, dev)
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
        lib.lstm_seq_int8_forward.argtypes = [p] * 11 + [i] * 7 + [p]
        lib.lstm_seq_int8_forward.restype = i
        lib.lstm_seq_int8_error_string.argtypes = [i]
        lib.lstm_seq_int8_error_string.restype = ctypes.c_char_p
        lib.lstm_seq_int8_quotient_check.argtypes = [p, ctypes.c_longlong, p]
        lib.lstm_seq_int8_quotient_check.restype = i
        lib._argtypes_set = True
    return lib


def int8_quotient_check(pairs: int, device="cuda") -> dict:
    """Kernel C's quantization of h (csrc/lstm_seq_int8.cu: quantize1, a
    reciprocal and one exact correction, the IEEE quotient near a
    half-integer) against clip(rint(IEEE h / hscale)) on `pairs` seeded
    (h, hscale) pairs on the card. Returns the counts: quotients that
    differ from the IEEE one (`differ`), by more than 4 ulps
    (`differ_above_4_ulps`), quantized values that differ (`hq_differ`,
    0 for an exact kernel), and pairs that took the IEEE quotient
    (`ieee_fallbacks`)."""
    lib = _lib_int8()
    counts = torch.zeros(4, dtype=torch.int64, device=device)
    dev = counts.device
    with torch.cuda.device(dev):
        rc = lib.lstm_seq_int8_quotient_check(
            counts.data_ptr(), pairs, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("int8_quotient_check failed: "
                           f"{lib.lstm_seq_int8_error_string(rc).decode()}")
    names = ("differ", "differ_above_4_ulps", "hq_differ", "ieee_fallbacks")
    return dict(zip(names, counts.tolist()))


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
    sms = build.sm_count(dev.index or 0)
    slices = batch_slices(n, fwd_plan, h, sms, 1)
    lib = _lib_int8()
    y = torch.empty((n, t, h), dtype=torch.float32, device=dev)
    yc = torch.empty((n, t, h), dtype=torch.float32, device=dev)
    # one cooperative launch per slice, each with its own exchange buffers
    # (float32 h by step parity, padding zero; each block's row maxima of
    # |h|, every slot written before it is read) and barrier counter
    for s0, rows in slices:
        plan = fwd_plan(rows, h, sms, 1)
        xbuf = torch.zeros(2 * plan.np * plan.kp, dtype=torch.float32, device=dev)
        amax = torch.empty(2 * plan.np * plan.grid, dtype=torch.float32, device=dev)
        rslice = rslice_scratch(plan, torch.int32, dev)
        bar = torch.empty(1, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.lstm_seq_int8_forward(
                wx[s0:s0 + rows].data_ptr(), rq_packed.data_ptr(), rscale.data_ptr(),
                h0[s0:s0 + rows].data_ptr(), c0[s0:s0 + rows].data_ptr(),
                y[s0:s0 + rows].data_ptr(), yc[s0:s0 + rows].data_ptr(),
                xbuf.data_ptr(), amax.data_ptr(),
                None if rslice is None else rslice.data_ptr(), bar.data_ptr(),
                rows, t, h, plan.grid, plan.units, plan.kw, int(plan.resident),
                stream,
            )
        if rc != 0:
            raise RuntimeError(f"{fn} kernel failed: "
                               f"{lib.lstm_seq_int8_error_string(rc).decode()}")
        LAUNCHES["lstm_seq_int8"] += 1
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
