"""Fused RNN-T joint log-prob kernels F, G, H (csrc/joint_lp.cu) and
their plain twins.

Port of the JAX package's Pallas kernels in ops/pallas/joint_lp.py:
`joint_lp_fwd_pallas` (F: the joint's log-probs of blank and of the
next label, without the [rows, V] logits in device memory) and the two
halves of `joint_lp_bwd_pallas` (G: d_enc_proj, d_pred_proj and the row
logsumexp; H: dW_out and db_out).

W_out's type is the rounding type w() of the joint's product inputs:
pass it already cast (bf16 under a bf16 compute policy, float32
otherwise). Every other input is float32; labels are int32 [N, U1 - 1].

Each wrapper takes its kernel for CUDA tensors and its plain twin for
CPU tensors; a CUDA tensor never falls back. `LAUNCHES` counts one per
wrapper call that launched its kernel (G and H are each a main kernel
and its reduction pass).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

KERNEL = "joint_lp"
LAUNCHES = {"joint_lp_fwd": 0, "joint_lp_dx": 0, "joint_lp_dw": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain twins: the same arithmetic over the whole [N, T, U1, V] lattice
# ---------------------------------------------------------------------------


def _rows(enc_proj, pred_proj, w_out):
    """(h float32, w(h) as float32) over the lattice [N, T, U1, J]."""
    h = torch.tanh(enc_proj.float()[:, :, None, :] + pred_proj.float()[:, None, :, :])
    return h, h.to(w_out.dtype).float()


def _logits(hq, w_out, b_out):
    return hq @ w_out.float() + b_out.float()


def _dlogits(logits, lse, labels, g_lpb, g_lpe, blank):
    """1[v = blank] g_lpb + 1[v = label_u] g_lpe - p (g_lpb + g_lpe), both
    one-hot terms added (a label may equal the blank)."""
    n, t, u1, v = logits.shape
    ge = torch.cat([g_lpe.float(), g_lpe.new_zeros((n, t, 1))], 2)
    gb = g_lpb.float()
    lab = torch.cat([labels.long(), labels.new_full((n, 1), -1).long()], 1)
    ids = torch.arange(v, device=logits.device)
    p = torch.exp(logits - lse[..., None])
    return ((ids == blank) * gb[..., None]
            + (ids == lab[:, None, :, None]) * ge[..., None]
            - p * (gb + ge)[..., None])


def joint_lp_fwd_reference(enc_proj, pred_proj, w_out, b_out, labels, blank=0):
    _, hq = _rows(enc_proj, pred_proj, w_out)
    logits = _logits(hq, w_out, b_out)
    lse = torch.logsumexp(logits, -1)
    u = labels.shape[1]
    emit = torch.gather(logits[:, :, :u], -1,
                        labels.long()[:, None, :, None].expand(-1, logits.shape[1], -1, 1))
    return logits[..., blank] - lse, emit[..., 0] - lse[:, :, :u]


def joint_lp_dx_reference(enc_proj, pred_proj, w_out, b_out, labels, g_lpb,
                          g_lpe, blank=0):
    h, hq = _rows(enc_proj, pred_proj, w_out)
    logits = _logits(hq, w_out, b_out)
    lse = torch.logsumexp(logits, -1)
    d = _dlogits(logits, lse, labels, g_lpb, g_lpe, blank)
    dh = (d.to(w_out.dtype).float() @ w_out.float().t()) * (1.0 - h * h)
    return dh.sum(2), dh.sum(1), lse


def joint_lp_dw_reference(enc_proj, pred_proj, w_out, b_out, labels, g_lpb,
                          g_lpe, lse, blank=0):
    _, hq = _rows(enc_proj, pred_proj, w_out)
    logits = _logits(hq, w_out, b_out)
    d = _dlogits(logits, lse.float(), labels, g_lpb, g_lpe, blank)
    j, v = w_out.shape
    dw = hq.reshape(-1, j).t() @ d.to(w_out.dtype).float().reshape(-1, v)
    return dw, d.reshape(-1, v).sum(0)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _lib():
    lib = build.load(KERNEL)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.joint_lp_scratch.argtypes = [i, i, i, i, i, i,
                                         ctypes.POINTER(ctypes.c_longlong)]
        lib.joint_lp_scratch.restype = i
        lib.joint_lp_fwd.argtypes = [p] * 7 + [i] * 7 + [p]
        lib.joint_lp_fwd.restype = i
        lib.joint_lp_dx.argtypes = [p] * 12 + [i] * 7 + [p]
        lib.joint_lp_dx.restype = i
        lib.joint_lp_dw.argtypes = [p] * 12 + [i] * 8 + [p]
        lib.joint_lp_dw.restype = i
        lib.joint_lp_error_string.argtypes = [i]
        lib.joint_lp_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _device(fn, enc_proj):
    dev = enc_proj.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {dev}")
    return dev


def _check_inputs(fn, enc_proj, pred_proj, w_out, b_out, labels, extra=()):
    """Shapes, types, device and contiguity; returns (N, T, U1, J, V)."""
    if enc_proj.dim() != 3 or pred_proj.dim() != 3 or w_out.dim() != 2:
        raise ValueError(f"{fn}: enc_proj [N,T,J], pred_proj [N,U1,J], "
                         "w_out [J,V] expected")
    n, t, j = enc_proj.shape
    u1, v = pred_proj.shape[1], w_out.shape[1]
    if min(n, t, u1, j, v) == 0:
        raise ValueError(f"{fn}: empty input")
    want = [("enc_proj", enc_proj, (n, t, j), torch.float32),
            ("pred_proj", pred_proj, (n, u1, j), torch.float32),
            ("b_out", b_out, (v,), torch.float32),
            ("labels", labels, (n, u1 - 1), torch.int32)]
    want += [(name, x, shape(n, t, u1), torch.float32) for name, x, shape in extra]
    if w_out.shape[0] != j or w_out.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{fn}: w_out must be [J, V] bf16 or float32, got "
                        f"{tuple(w_out.shape)} {w_out.dtype}")
    if w_out.data_ptr() % 16:
        raise ValueError(f"{fn}: w_out must start on a 16-byte boundary")
    for name, x, shape, dtype in want + [("w_out", w_out, (j, v), w_out.dtype)]:
        if x.device != enc_proj.device:
            raise ValueError(f"{fn}: {name} is on {x.device}, enc_proj on "
                             f"{enc_proj.device}")
        if x.dtype != dtype:
            raise TypeError(f"{fn}: {name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{fn}: {name} has shape {tuple(x.shape)}, "
                             f"expected {tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    return n, t, u1, j, v


def _run(fn, lib, rc):
    if rc != 0:
        raise RuntimeError(f"{fn} kernel failed: "
                           f"{lib.joint_lp_error_string(rc).decode()}")


def _scratch(lib, n, t, u1, j, v, bf16):
    out = (ctypes.c_longlong * 6)()
    lib.joint_lp_scratch(n, t, u1, j, v, int(bf16), out)
    return [int(x) for x in out]


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


_G = (lambda n, t, u1: (n, t, u1))
_E = (lambda n, t, u1: (n, t, u1 - 1))


def joint_lp_fwd(enc_proj, pred_proj, w_out, b_out, labels, blank: int = 0):
    """Kernel F. Returns (lp_blank [N, T, U1], lp_emit [N, T, U1 - 1])."""
    fn = "joint_lp_fwd"
    if _device(fn, enc_proj).type == "cpu":
        return joint_lp_fwd_reference(enc_proj, pred_proj, w_out, b_out,
                                      labels, blank)
    n, t, u1, j, v = _check_inputs(fn, enc_proj, pred_proj, w_out, b_out, labels)
    dev = enc_proj.device
    lib = _lib()
    lpb = torch.empty((n, t, u1), dtype=torch.float32, device=dev)
    lpe = torch.empty((n, t, u1 - 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.joint_lp_fwd(
            enc_proj.data_ptr(), pred_proj.data_ptr(), w_out.data_ptr(),
            b_out.data_ptr(), labels.data_ptr(), lpb.data_ptr(),
            lpe.data_ptr(), n, t, u1, j, v, blank,
            int(w_out.dtype == torch.bfloat16), _stream(dev))
    _run(fn, lib, rc)
    LAUNCHES[fn] += 1
    return lpb, lpe


def joint_lp_dx(enc_proj, pred_proj, w_out, b_out, labels, g_lpb, g_lpe,
                blank: int = 0):
    """Kernel G. g_lpb [N, T, U1], g_lpe [N, T, U1 - 1] float32. Returns
    (d_enc_proj [N, T, J], d_pred_proj [N, U1, J], lse [N, T, U1])."""
    fn = "joint_lp_dx"
    if _device(fn, enc_proj).type == "cpu":
        return joint_lp_dx_reference(enc_proj, pred_proj, w_out, b_out,
                                     labels, g_lpb, g_lpe, blank)
    n, t, u1, j, v = _check_inputs(
        fn, enc_proj, pred_proj, w_out, b_out, labels,
        (("g_lpb", g_lpb, _G), ("g_lpe", g_lpe, _E)))
    dev = enc_proj.device
    lib = _lib()
    bf16 = w_out.dtype == torch.bfloat16
    sizes = _scratch(lib, n, t, u1, j, v, bf16)
    f32 = dict(dtype=torch.float32, device=dev)
    d_enc = torch.empty((n, t, j), **f32)
    d_pred = torch.empty((n, u1, j), **f32)
    lse = torch.empty((n, t, u1), **f32)
    part_enc = torch.empty(sizes[0], **f32)
    part_pred = torch.empty(sizes[1], **f32)
    with torch.cuda.device(dev):
        rc = lib.joint_lp_dx(
            enc_proj.data_ptr(), pred_proj.data_ptr(), w_out.data_ptr(),
            b_out.data_ptr(), labels.data_ptr(), g_lpb.data_ptr(),
            g_lpe.data_ptr(), d_enc.data_ptr(), d_pred.data_ptr(),
            lse.data_ptr(), part_enc.data_ptr(), part_pred.data_ptr(),
            n, t, u1, j, v, blank, int(bf16), _stream(dev))
    _run(fn, lib, rc)
    LAUNCHES[fn] += 1
    return d_enc, d_pred, lse


def joint_lp_dw(enc_proj, pred_proj, w_out, b_out, labels, g_lpb, g_lpe, lse,
                blank: int = 0):
    """Kernel H, with G's lse. Returns (dW_out [J, V], db_out [V]), both
    float32."""
    fn = "joint_lp_dw"
    if _device(fn, enc_proj).type == "cpu":
        return joint_lp_dw_reference(enc_proj, pred_proj, w_out, b_out,
                                     labels, g_lpb, g_lpe, lse, blank)
    n, t, u1, j, v = _check_inputs(
        fn, enc_proj, pred_proj, w_out, b_out, labels,
        (("g_lpb", g_lpb, _G), ("g_lpe", g_lpe, _E), ("lse", lse, _G)))
    dev = enc_proj.device
    lib = _lib()
    bf16 = w_out.dtype == torch.bfloat16
    sizes = _scratch(lib, n, t, u1, j, v, bf16)
    f32 = dict(dtype=torch.float32, device=dev)
    dw = torch.empty((j, v), **f32)
    db = torch.empty((v,), **f32)
    part_w = torch.empty(sizes[3], **f32)
    part_b = torch.empty(sizes[4], **f32)
    with torch.cuda.device(dev):
        rc = lib.joint_lp_dw(
            enc_proj.data_ptr(), pred_proj.data_ptr(), w_out.data_ptr(),
            b_out.data_ptr(), labels.data_ptr(), g_lpb.data_ptr(),
            g_lpe.data_ptr(), lse.data_ptr(), dw.data_ptr(), db.data_ptr(),
            part_w.data_ptr(), part_b.data_ptr(), sizes[2],
            n, t, u1, j, v, blank, int(bf16), _stream(dev))
    _run(fn, lib, rc)
    LAUNCHES[fn] += 1
    return dw, db
