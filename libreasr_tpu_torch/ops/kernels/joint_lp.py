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
wrapper call that launched its kernels. With bf16 W_out, G makes five
launches per chunk of frame groups, planned by `dx_plan` (w(h), the
logits product with a (max, sum) epilogue, the lse fold, the logits
product with the dlogits epilogue, the dh product with the label and
frame sums in its epilogue) and one fold; H four per chunk of lattice
rows, planned by `dw_plan` (w(h), the logits product with the dlogits
epilogue, the dW product and the fold). With float32 W_out each is a
main kernel and its reduction.

G and H with bf16 W_out keep w(h) and w(dlogits) of a chunk of rows in
bf16 scratch that the wrapper allocates; the plans cut the lattice into
chunks so that the scratch stays under `scratch_cap` bytes
(DW_SCRATCH_CAP unless the caller gives another). G's d_enc_proj and
d_pred_proj partials lie outside the cap: they scale with the lattice.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

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
# H with bf16 W_out: the row-chunk plan, and the twin taken over it
# ---------------------------------------------------------------------------

DW_SCRATCH_CAP = 256 * 2**20   # bytes of H's scratch at most, by default
DW_TILE = 128                  # rows and columns of a product tile
DW_K = 64                      # K depth of a stage


@dataclass(frozen=True)
class DwPlan:
    """H's walk over the R = N T U1 lattice rows (flat index
    (n T + t) U1 + u): `chunks` are (first row, rows), in order, each at
    most `chunk_rows` (a multiple of DW_TILE); within a chunk the dW
    product's K (the rows) is cut into `groups` runs of `group_rows`.
    jp, vp: w(h)'s and w(dlogits)' row lengths (J rounded up to 64, V to
    8); `scratch_bytes`: all that the wrapper allocates for it."""
    rows: int
    jp: int
    vp: int
    chunk_rows: int
    groups: int
    scratch_bytes: int
    chunks: tuple

    def group_rows(self, rows_c: int) -> int:
        k_total = -(-rows_c // DW_K)
        return -(-k_total // self.groups) * DW_K


def dw_plan(n: int, t: int, u1: int, j: int, v: int, cap: int,
            sms: int) -> DwPlan:
    """Chunks of lattice rows whose scratch fits `cap` bytes: per 128-row
    tile, w(h) and w(dlogits) in bf16 (128 (jp + vp) 2 B) and a row of db
    partials (4 V B); besides, `groups` float32 [J, V] dW partials and,
    when V is not a multiple of 8, W_out padded to vp. Groups split the
    dW product's K only when its J x V tiles alone would leave most of
    the `sms` SMs idle, and keep at least 8 K stages each. Raises when
    not even one tile fits."""
    rows = n * t * u1
    jp, vp = -(-j // 64) * 64, -(-v // 8) * 8
    tiles_mn = -(-j // DW_TILE) * -(-v // DW_TILE)
    groups = max(1, min(sms // tiles_mn, -(-rows // DW_K) // 8))
    fixed = groups * j * v * 4 + (j * vp * 2 if v % 8 else 0)
    tile_bytes = DW_TILE * (jp + vp) * 2 + 4 * v
    tiles = min((cap - fixed) // tile_bytes, -(-rows // DW_TILE))
    if tiles < 1:
        raise ValueError(f"joint_lp_dw: a scratch cap of {cap} B holds no "
                         f"{DW_TILE}-row chunk (needs {fixed + tile_bytes} B)")
    chunk = tiles * DW_TILE
    chunks = tuple((r0, min(chunk, rows - r0)) for r0 in range(0, rows, chunk))
    return DwPlan(rows, jp, vp, chunk, groups, fixed + tiles * tile_bytes, chunks)


def joint_lp_dw_chunked_reference(enc_proj, pred_proj, w_out, b_out, labels,
                                  g_lpb, g_lpe, lse, plan: DwPlan, blank=0):
    """The twin of H taken the way the bf16 kernel walks the lattice: per
    chunk of `plan`, each group's dW partial over its rows, added to dW
    in group order, chunk after chunk, and db's per-chunk sums likewise
    (float32 throughout)."""
    _, hq = _rows(enc_proj, pred_proj, w_out)
    logits = _logits(hq, w_out, b_out)
    d = _dlogits(logits, lse.float(), labels, g_lpb, g_lpe, blank)
    j, v = w_out.shape
    hq = hq.reshape(-1, j)
    d = d.reshape(-1, v)
    dq = d.to(w_out.dtype).float()
    dw = torch.zeros((j, v), dtype=torch.float32, device=hq.device)
    db = torch.zeros((v,), dtype=torch.float32, device=hq.device)
    for r0, rc in plan.chunks:
        step = plan.group_rows(rc)
        part = [hq[a:b].t() @ dq[a:b] for a, b in
                ((r0 + g * step, r0 + min((g + 1) * step, rc))
                 for g in range(plan.groups))]
        dw = dw + sum(part[1:], part[0])
        db = db + d[r0:r0 + rc].sum(0)
    return dw, db


# ---------------------------------------------------------------------------
# G with bf16 W_out: the frame-group plan, and the twin taken over it
# ---------------------------------------------------------------------------

DX_FRAMES = 8      # frames of a dh tile (one utterance)
DX_LABELS = 16     # labels of a dh tile: 8 x 16 = the 128 product rows
DX_VTILE = 128     # logits columns of a tile: one (max, sum) partial per row


@dataclass(frozen=True)
class DxPlan:
    """G's walk over the lattice: `groups` of up to DX_FRAMES frames of one
    utterance ((n, tb), n-major), cut into `chunks` (first group, groups,
    first row, rows) of contiguous rows whose scratch (w(h), w(dlogits),
    the row (max, sum) partials) stays under the cap; ntb, nub: the frame
    and label blocks of an utterance (dh tiles: ntb x nub per utterance);
    jp, vp as for H; `partial_bytes`: the [nub] d_enc_proj and [ntb]
    d_pred_proj partials, which scale with the lattice as the first
    design's did; `scratch_bytes`: all that the wrapper allocates."""
    rows: int
    jp: int
    vp: int
    ntb: int
    nub: int
    vtiles: int
    chunk_rows: int
    groups_per_chunk: int
    partial_bytes: int
    scratch_bytes: int
    chunks: tuple


def dx_plan(n: int, t: int, u1: int, j: int, v: int, cap: int) -> DxPlan:
    """Chunks of whole frame groups whose per-row scratch fits `cap`
    bytes: w(h) and w(dlogits) in bf16 and the logits' (max, sum) per
    row and 128-column tile. Every chunk holds the same number of groups
    (the last one fewer). Raises when not even one group fits."""
    jp, vp = -(-j // 64) * 64, -(-v // 8) * 8
    ntb, nub, vtiles = -(-t // DX_FRAMES), -(-u1 // DX_LABELS), -(-v // DX_VTILE)
    row_bytes = 2 * (jp + vp) + 8 * vtiles
    group_rows = min(t, DX_FRAMES) * u1
    per_chunk = cap // (row_bytes * group_rows)
    if per_chunk < 1:
        raise ValueError(f"joint_lp_dx: a scratch cap of {cap} B holds no frame "
                         f"group (needs {row_bytes * group_rows} B)")
    groups = n * ntb

    def first_frame(g):
        return (g // ntb) * t + (g % ntb) * DX_FRAMES

    def end_frame(g):  # one past the last frame of group g
        return (g // ntb) * t + min(t, (g % ntb + 1) * DX_FRAMES)

    chunks = []
    for g0 in range(0, groups, per_chunk):
        g1 = min(groups, g0 + per_chunk)
        f0, f1 = first_frame(g0), end_frame(g1 - 1)
        chunks.append((g0, g1 - g0, f0 * u1, (f1 - f0) * u1))
    chunk_rows = max(rc for *_, rc in chunks)
    partial = 4 * j * (nub * n * t + ntb * n * u1)
    scratch = chunk_rows * row_bytes + partial + (j * vp * 2 if v % 8 else 0)
    return DxPlan(n * t * u1, jp, vp, ntb, nub, vtiles, chunk_rows,
                  min(per_chunk, groups), partial, scratch, tuple(chunks))


def joint_lp_dx_chunked_reference(enc_proj, pred_proj, w_out, b_out, labels,
                                  g_lpb, g_lpe, plan: DxPlan, blank=0):
    """The twin of G taken the way the bf16 kernel walks the lattice: the
    row lse folded from (max, sum) partials over 128-column tiles of V in
    order; dh summed over each tile's 16 labels into [nub] d_enc_proj
    partials and over its 8 frames into [ntb] d_pred_proj partials, both
    added in order (float32 throughout). Returns (d_enc_proj,
    d_pred_proj, lse)."""
    h, hq = _rows(enc_proj, pred_proj, w_out)
    logits = _logits(hq, w_out, b_out)
    n, t, u1, v = logits.shape
    m = torch.stack([logits[..., a:a + DX_VTILE].amax(-1)
                     for a in range(0, v, DX_VTILE)])
    s = torch.stack([torch.exp(logits[..., a:a + DX_VTILE] - m[k, ..., None]).sum(-1)
                     for k, a in enumerate(range(0, v, DX_VTILE))])
    top = m.amax(0)
    acc = torch.zeros_like(top)
    for k in range(m.shape[0]):
        acc = acc + s[k] * torch.exp(m[k] - top)
    lse = top + torch.log(acc)
    d = _dlogits(logits, lse, labels, g_lpb, g_lpe, blank)
    dh = (d.to(w_out.dtype).float() @ w_out.float().t()) * (1.0 - h * h)
    d_enc = torch.zeros((n, t, dh.shape[-1]), dtype=torch.float32, device=dh.device)
    d_pred = torch.zeros((n, u1, dh.shape[-1]), dtype=torch.float32, device=dh.device)
    for ub in range(plan.nub):
        d_enc = d_enc + dh[:, :, ub * DX_LABELS:(ub + 1) * DX_LABELS].sum(2)
    for tb in range(plan.ntb):
        d_pred = d_pred + dh[:, tb * DX_FRAMES:(tb + 1) * DX_FRAMES].sum(1)
    return d_enc, d_pred, lse


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _lib():
    lib = build.load(KERNEL)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.joint_lp_scratch.argtypes = [i, i, i, i, i,
                                         ctypes.POINTER(ctypes.c_longlong)]
        lib.joint_lp_scratch.restype = i
        lib.joint_lp_fwd.argtypes = [p] * 7 + [i] * 7 + [p]
        lib.joint_lp_fwd.restype = i
        lib.joint_lp_dx.argtypes = [p] * 12 + [i] * 6 + [p]
        lib.joint_lp_dx_tc.argtypes = [p, p, p, i] + [p] * 12 + [i] * 9 + [p]
        lib.joint_lp_dx_tc.restype = i
        lib.joint_lp_dx.restype = i
        lib.joint_lp_dw.argtypes = [p] * 12 + [i] * 7 + [p]
        lib.joint_lp_dw.restype = i
        lib.joint_lp_dw_tc.argtypes = [p, p, p, i] + [p] * 11 + [i] * 10 + [p]
        lib.joint_lp_dw_tc.restype = i
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


def _scratch(lib, n, t, u1, j, v):
    """Partials of G and H with float32 W_out (joint_lp_scratch)."""
    out = (ctypes.c_longlong * 5)()
    lib.joint_lp_scratch(n, t, u1, j, v, out)
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
                blank: int = 0, scratch_cap: int = DW_SCRATCH_CAP):
    """Kernel G. g_lpb [N, T, U1], g_lpe [N, T, U1 - 1] float32. Returns
    (d_enc_proj [N, T, J], d_pred_proj [N, U1, J], lse [N, T, U1]). With
    bf16 W_out the kernel's per-row scratch stays under `scratch_cap`
    bytes (see `dx_plan`)."""
    fn = "joint_lp_dx"
    if _device(fn, enc_proj).type == "cpu":
        return joint_lp_dx_reference(enc_proj, pred_proj, w_out, b_out,
                                     labels, g_lpb, g_lpe, blank)
    n, t, u1, j, v = _check_inputs(
        fn, enc_proj, pred_proj, w_out, b_out, labels,
        (("g_lpb", g_lpb, _G), ("g_lpe", g_lpe, _E)))
    dev = enc_proj.device
    lib = _lib()
    if w_out.dtype == torch.bfloat16:
        out = _dx_tensor_cores(lib, enc_proj, pred_proj, w_out, b_out, labels,
                               g_lpb, g_lpe, blank, scratch_cap)
        LAUNCHES[fn] += 1
        return out
    sizes = _scratch(lib, n, t, u1, j, v)
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
            n, t, u1, j, v, blank, _stream(dev))
    _run(fn, lib, rc)
    LAUNCHES[fn] += 1
    return d_enc, d_pred, lse


def _pad_w(w_out, vp):
    """W_out with rows of a multiple of 16 bytes, as TMA reads them."""
    v = w_out.shape[1]
    return w_out if v % 8 == 0 else torch.nn.functional.pad(w_out, (0, vp - v))


def _dx_tensor_cores(lib, enc_proj, pred_proj, w_out, b_out, labels, g_lpb,
                     g_lpe, blank, cap):
    """G with bf16 W_out: scratch from `dx_plan`, one C call that walks
    the chunks."""
    n, t, j = enc_proj.shape
    u1, v = pred_proj.shape[1], w_out.shape[1]
    dev = enc_proj.device
    plan = dx_plan(n, t, u1, j, v, cap)
    w = _pad_w(w_out, plan.vp)
    bf = dict(dtype=torch.bfloat16, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    hs = torch.empty(plan.chunk_rows * plan.jp, **bf)
    d = torch.empty(plan.chunk_rows * plan.vp, **bf)
    ms = torch.empty(2 * plan.vtiles * plan.chunk_rows, **f32)
    enc_part = torch.empty(n * t * plan.nub * j, **f32)
    pred_part = torch.empty(n * plan.ntb * u1 * j, **f32)
    d_enc = torch.empty((n, t, j), **f32)
    d_pred = torch.empty((n, u1, j), **f32)
    lse = torch.empty((n, t, u1), **f32)
    with torch.cuda.device(dev):
        rc = lib.joint_lp_dx_tc(
            enc_proj.data_ptr(), pred_proj.data_ptr(), w.data_ptr(), w.shape[1],
            b_out.data_ptr(), labels.data_ptr(), g_lpb.data_ptr(),
            g_lpe.data_ptr(), d_enc.data_ptr(), d_pred.data_ptr(), lse.data_ptr(),
            hs.data_ptr(), d.data_ptr(), ms.data_ptr(), enc_part.data_ptr(),
            pred_part.data_ptr(), n, t, u1, j, v, blank, plan.jp, plan.vp,
            plan.groups_per_chunk, _stream(dev))
    _run("joint_lp_dx", lib, rc)
    return d_enc, d_pred, lse


def _dw_tensor_cores(lib, enc_proj, pred_proj, w_out, b_out, labels, g_lpb,
                     g_lpe, lse, blank, cap):
    """H with bf16 W_out: scratch from `dw_plan`, one C call that walks
    the chunks."""
    n, t, u1 = lse.shape
    j, v = w_out.shape
    dev = enc_proj.device
    plan = dw_plan(n, t, u1, j, v, cap, build.sm_count(dev.index or 0))
    w = _pad_w(w_out, plan.vp)
    bf = dict(dtype=torch.bfloat16, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    hs = torch.empty(plan.chunk_rows * plan.jp, **bf)
    d = torch.empty(plan.chunk_rows * plan.vp, **bf)
    dbpart = torch.empty(plan.chunk_rows // DW_TILE * v, **f32)
    part = torch.empty(plan.groups * j * v, **f32)
    dw = torch.empty((j, v), **f32)
    db = torch.empty((v,), **f32)
    with torch.cuda.device(dev):
        rc = lib.joint_lp_dw_tc(
            enc_proj.data_ptr(), pred_proj.data_ptr(), w.data_ptr(), w.shape[1],
            b_out.data_ptr(), labels.data_ptr(), g_lpb.data_ptr(),
            g_lpe.data_ptr(), lse.data_ptr(), dw.data_ptr(), db.data_ptr(),
            hs.data_ptr(), d.data_ptr(), dbpart.data_ptr(), part.data_ptr(),
            n, t, u1, j, v, blank, plan.jp, plan.vp, plan.chunk_rows,
            plan.groups, _stream(dev))
    _run("joint_lp_dw", lib, rc)
    return dw, db


def joint_lp_dw(enc_proj, pred_proj, w_out, b_out, labels, g_lpb, g_lpe, lse,
                blank: int = 0, scratch_cap: int = DW_SCRATCH_CAP):
    """Kernel H, with G's lse. Returns (dW_out [J, V], db_out [V]), both
    float32. With bf16 W_out the kernel's scratch stays under
    `scratch_cap` bytes (see `dw_plan`)."""
    fn = "joint_lp_dw"
    if _device(fn, enc_proj).type == "cpu":
        return joint_lp_dw_reference(enc_proj, pred_proj, w_out, b_out,
                                     labels, g_lpb, g_lpe, lse, blank)
    n, t, u1, j, v = _check_inputs(
        fn, enc_proj, pred_proj, w_out, b_out, labels,
        (("g_lpb", g_lpb, _G), ("g_lpe", g_lpe, _E), ("lse", lse, _G)))
    dev = enc_proj.device
    lib = _lib()
    if w_out.dtype == torch.bfloat16:
        out = _dw_tensor_cores(lib, enc_proj, pred_proj, w_out, b_out, labels,
                               g_lpb, g_lpe, lse, blank, scratch_cap)
        LAUNCHES[fn] += 1
        return out
    sizes = _scratch(lib, n, t, u1, j, v)
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
            n, t, u1, j, v, blank, _stream(dev))
    _run(fn, lib, rc)
    LAUNCHES[fn] += 1
    return dw, db
