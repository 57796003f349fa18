"""Host-side plans of the redesigned kernels H and E, on the CPU.

H (ops/kernels/joint_lp.py:dw_plan): the bf16 kernel walks the lattice
rows in chunks whose w(h) and w(dlogits) scratch stays under a cap, and
splits each chunk's dW product over row groups. The plan must cover
every row once, in order, within the cap; the twin taken chunk by chunk
and group by group over it (joint_lp_dw_chunked_reference, the kernel's
order of sums) must equal the unchunked twin and JAX's Pallas backward
in interpret mode.

E (ops/kernels/lstm_train.py:bwd_plan): one cooperative launch whose
blocks own disjoint runs of hidden units and keep those rows of R in
shared memory; the partition must cover [0, H) once with no more blocks
than SMs, and raise where R's slice cannot fit. The wrappers of E and of
the sequence kernel A/B run a batch the plan does not take in slices
(batch_slices): every row in one slice, every slice one the plan takes.

A/B (ops/kernels/lstm.py:fwd_plan): one cooperative launch whose blocks
own disjoint runs of hidden units and stage those gate columns of R,
in shared memory on the main path and read from L2 past the resident
range.

G (ops/kernels/joint_lp.py:dx_plan): chunks of whole frame groups, in
order, within the cap; the twin taken over its tiles and partials
(joint_lp_dx_chunked_reference, with F's lse) must equal the unchunked
twin and JAX's Pallas backward in interpret mode.

F (ops/kernels/joint_lp.py:lp_plan): chunks of lattice rows, in order,
within the cap; the twin taken over them (joint_lp_fwd_chunked_reference:
the row lse folded from per-128-column (max, sum) partials) must equal
the unchunked twin and JAX's Pallas forward in interpret mode.

Tolerances as in tests/test_torch_joint_lp.py: float32 W_out, the same
float32 sums in another order: 1e-5 (relative for the chunked twin
against the unchunked one; of each gradient's largest entry against
JAX). bf16 W_out against JAX: 1e-3 of the largest entry (an order
difference can flip one bf16 rounding of dlogits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libreasr_tpu.ops.pallas.joint_lp import joint_lp_bwd_pallas, joint_lp_fwd_pallas
from libreasr_tpu_torch.ops.kernels import joint_lp as kj
from libreasr_tpu_torch.ops.kernels import lstm as klstm
from libreasr_tpu_torch.ops.kernels import lstm_train as klt


@pytest.mark.parametrize("shape,cap", [
    ((16, 49, 41, 1024, 2048), kj.DW_SCRATCH_CAP),   # the main path: one chunk
    ((16, 49, 41, 1024, 2048), 40 * 2**20),           # the same, six chunks
    ((2, 11, 101, 200, 300), 2 * 2**20),              # V off 8: W_out padded
    ((3, 13, 9, 96, 40), 200_000),
    ((1, 1, 2, 8, 5), kj.DW_SCRATCH_CAP),             # a single short chunk
])
def test_dw_plan_covers_rows_once_under_cap(shape, cap):
    n, t, u1, j, v = shape
    plan = kj.dw_plan(n, t, u1, j, v, cap=cap, sms=132)
    assert plan.rows == n * t * u1
    assert plan.chunk_rows % kj.DW_TILE == 0
    assert plan.jp % 64 == 0 and plan.jp >= j and plan.vp % 8 == 0 and plan.vp >= v
    seen = np.zeros(plan.rows, np.int64)
    expect = 0
    for r0, rc in plan.chunks:
        assert r0 == expect and 0 < rc <= plan.chunk_rows  # in order, no gap
        seen[r0:r0 + rc] += 1
        expect = r0 + rc
        step = plan.group_rows(rc)
        assert step % kj.DW_K == 0 and step * plan.groups >= rc
    assert expect == plan.rows and (seen == 1).all()
    assert plan.scratch_bytes <= cap
    # what the wrapper allocates is what the plan counts
    tiles = plan.chunk_rows // kj.DW_TILE
    allocated = (plan.chunk_rows * (plan.jp + plan.vp) * 2 + tiles * v * 4
                 + plan.groups * j * v * 4 + (j * plan.vp * 2 if v % 8 else 0))
    assert allocated == plan.scratch_bytes


def test_dw_plan_groups_fill_the_card_only_when_tiles_do_not():
    cap = kj.DW_SCRATCH_CAP
    main = kj.dw_plan(16, 49, 41, 1024, 2048, cap=cap, sms=132)
    assert main.groups == 1  # 8 x 16 product tiles for 132 SMs
    small = kj.dw_plan(16, 49, 41, 96, 40, cap=cap, sms=132)
    assert small.groups > 1
    k_stages = -(-small.chunks[0][1] // kj.DW_K)
    assert k_stages // small.groups >= 8


def test_dw_plan_raises_below_one_chunk():
    with pytest.raises(ValueError, match="holds no 128-row chunk"):
        kj.dw_plan(16, 49, 41, 1024, 2048, cap=2**20, sms=132)


def _joint_inputs(n, t, u1, j, v, seed):
    rng = np.random.default_rng(seed)
    enc = (rng.standard_normal((n, t, j)) * 0.5).astype(np.float32)
    pred = (rng.standard_normal((n, u1, j)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((j, v)) / np.sqrt(j)).astype(np.float32)
    b = (rng.standard_normal(v) * 0.1).astype(np.float32)
    lab = rng.integers(1, v, (n, u1 - 1)).astype(np.int32)
    lab[0, 0] = 0  # a label equal to the blank
    gb = rng.standard_normal((n, t, u1)).astype(np.float32) * 0.1
    ge = rng.standard_normal((n, t, u1 - 1)).astype(np.float32) * 0.1
    return enc, pred, w, b, lab, gb, ge


@pytest.mark.parametrize("shape,cap,chunks,groups", [
    ((3, 13, 9, 24, 40), 10**7, 1, 1),       # golden-like, 351 rows
    ((3, 13, 9, 24, 40), 60_000, 2, 1),
    ((3, 13, 9, 24, 40), 40_000, 3, 1),
    ((4, 20, 15, 24, 40), 10**7, 1, 2),      # 1,200 rows: two row groups
    ((4, 20, 15, 24, 40), 120_000, 3, 2),
], ids=["golden-1", "golden-2", "golden-3", "grouped-1", "grouped-3"])
def test_chunked_twin_matches_unchunked_and_jax(shape, cap, chunks, groups):
    """One chunk or several, one row group or two per chunk."""
    n, t, u1, j, v = shape
    arrays = _joint_inputs(n, t, u1, j, v, seed=7)
    x = [torch.from_numpy(a) for a in arrays]
    lse = kj.joint_lp_fwd_reference(*x[:5])[2]
    plan = kj.dw_plan(n, t, u1, j, v, cap=cap, sms=132)
    assert (len(plan.chunks), plan.groups) == (chunks, groups)
    got = kj.joint_lp_dw_chunked_reference(*x, lse, plan)
    whole = kj.joint_lp_dw_reference(*x, lse)
    for a, b in zip(got, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))
    grads = joint_lp_bwd_pallas(*(jnp.asarray(a) for a in arrays), 0,
                                interpret=True, w_dtype=jnp.float32)
    for a, b in zip(got, grads[2:]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * float(np.abs(b).max()))


def test_chunked_twin_bf16_matches_jax():
    n, t, u1, j, v = 2, 11, 9, 24, 40
    arrays = _joint_inputs(n, t, u1, j, v, seed=8)
    x = [torch.from_numpy(a) for a in arrays]
    x[2] = x[2].bfloat16()
    lse = kj.joint_lp_fwd_reference(*x[:5])[2]
    plan = kj.dw_plan(n, t, u1, j, v, cap=40_000, sms=4)
    assert len(plan.chunks) > 1
    got = kj.joint_lp_dw_chunked_reference(*x, lse, plan)
    grads = joint_lp_bwd_pallas(*(jnp.asarray(a) for a in arrays), 0,
                                interpret=True, w_dtype=jnp.bfloat16)
    for a, b in zip(got, grads[2:]):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-3 * float(np.abs(b).max()))


@pytest.mark.parametrize("n,h,itemsize", [
    (16, 1024, 2), (16, 1024, 4), (3, 96, 2), (13, 100, 4), (4, 64, 4),
    (16, 1, 2), (16, 1500, 2),
])
def test_bwd_plan_partitions_units_once(n, h, itemsize):
    sms = 132
    plan = klt.bwd_plan(n, h, itemsize, sms)
    assert plan.grid <= sms
    assert plan.units % 8 == 0
    owned = np.zeros(h, np.int64)
    for b in range(plan.grid):
        for j in plan.units_of(b):
            owned[j] += 1
    assert (owned == 1).all()
    assert plan.smem <= klt.MAX_SMEM
    assert plan.np % 16 == 0 and plan.np >= n
    assert plan.kp % 32 == 0 and plan.kp >= 4 * h


def test_bwd_plan_main_path_keeps_r_slice_resident():
    plan = klt.bwd_plan(16, 1024, 2, 132)
    assert (plan.grid, plan.units) == (128, 8)
    # 8 rows of 4H bf16 (64 KB and padding) plus the warps' partials
    assert 8 * 4096 * 2 < plan.smem <= 80 * 1024


@pytest.mark.parametrize("n,h,itemsize,sms,match", [
    (16, 4096, 4, 132, "does not fit|shared memory"),   # R slice too large
    (16, 1500, 4, 132, "shared memory"),                # 16 f32 rows of 6000
    (16, 1024, 2, 32, "co-resident"),                   # more blocks than SMs
    (300, 64, 2, 132, "epilogue"),                      # batch beyond the owners
])
def test_bwd_plan_raises_where_it_cannot_run(n, h, itemsize, sms, match):
    with pytest.raises(ValueError, match=match):
        klt.bwd_plan(n, h, itemsize, sms)


def _covers_once(n, slices):
    seen = np.zeros(n, np.int64)
    expect = 0
    for s0, rows in slices:
        assert s0 == expect and rows > 0  # contiguous, in order
        seen[s0:s0 + rows] += 1
        expect = s0 + rows
    return expect == n and (seen == 1).all()


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n", [1, 16, 255, 256, 257, 300, 777, 1024])
def test_batch_slices_cover_rows_under_bwd_plan(n, itemsize):
    slices = klt.batch_slices(n, klt.bwd_plan, 1024, itemsize, 132)
    assert _covers_once(n, slices)
    for _, rows in slices:
        klt.bwd_plan(rows, 1024, itemsize, 132)  # each slice is planned
    assert len(slices) == -(-n // slices[0][1])  # the largest first slice


def test_batch_slices_main_batch_is_one_slice_and_300_is_two():
    assert klt.batch_slices(16, klt.bwd_plan, 1024, 2, 132) == [(0, 16)]
    assert klt.batch_slices(300, klt.bwd_plan, 1024, 2, 132) == [(0, 256), (256, 44)]


def test_batch_slices_raise_the_plans_reason_when_no_row_fits():
    with pytest.raises(ValueError, match="shared memory"):
        klt.batch_slices(4, klt.bwd_plan, 4096, 4, 132)


@pytest.mark.parametrize("h", [96, 1024])
@pytest.mark.parametrize("n", [1, 8, 300, 512, 513, 1024])
def test_batch_slices_cover_rows_under_fwd_plan(n, h):
    slices = klstm.batch_slices(n, klstm.fwd_plan, h, 132)
    assert _covers_once(n, slices)
    for _, rows in slices:
        klstm.fwd_plan(rows, h, 132)


@pytest.mark.parametrize("n,h", [(16, 1024), (8, 96), (13, 100), (64, 1024),
                                 (300, 1024), (16, 2048), (3, 5216)])
def test_fwd_plan_partitions_units_once(n, h):
    sms = 132
    plan = klstm.fwd_plan(n, h, sms)
    assert plan.grid <= sms and plan.units % 8 == 0
    assert plan.kw in (1, 2, 4, 8, 16)
    owned = np.zeros(h, np.int64)
    for b in range(plan.grid):
        for j in plan.units_of(b):
            owned[j] += 1
    assert (owned == 1).all()
    assert n * plan.units <= klstm.SEQ_MAXC * klstm.SEQ_THREADS
    assert plan.smem == klstm.fwd_smem_bytes(n, plan.kp, plan.units, plan.kw,
                                             plan.resident) <= klstm.MAX_SMEM
    assert plan.np % 16 == 0 and plan.np >= n
    assert plan.kp % 32 == 0 and plan.kp >= h
    assert plan.rstride >= plan.kp and plan.rstride % 64 == 32


def test_fwd_plan_main_path_keeps_r_slice_resident():
    plan = klstm.fwd_plan(16, 1024, 132)
    assert (plan.grid, plan.units, plan.kw, plan.resident) == (128, 8, 16, True)
    # 32 gate columns of H bf16 (64 KB and padding) plus the K-slices'
    # partial products of one 16-row tile
    assert 32 * 1024 * 2 < plan.smem <= 100 * 1024
    golden = klstm.fwd_plan(8, 96, 132)
    assert (golden.grid, golden.resident) == (12, True)


def test_fwd_plan_reads_r_from_l2_past_the_resident_range():
    # 16 units a block (128 blocks for 132 SMs): 64 columns of 2048 bf16
    # do not fit a block's shared memory beside the partials
    plan = klstm.fwd_plan(16, 2048, 132)
    assert (plan.units, plan.resident) == (16, False)
    assert klstm.fwd_smem_bytes(16, plan.kp, 16, 1, True) > klstm.MAX_SMEM


@pytest.mark.parametrize("n,h,match", [
    (513, 1024, "epilogue"),        # above 8 x 512 (row, unit) owners
    (16, 8200, "exceeds"),          # above the kernel's widest H
])
def test_fwd_plan_raises_where_it_cannot_run(n, h, match):
    with pytest.raises(ValueError, match=match):
        klstm.fwd_plan(n, h, 132)


@pytest.mark.parametrize("shape,cap,chunks", [
    ((16, 49, 41, 1024, 2048), kj.DW_SCRATCH_CAP, 1),   # the main path
    ((16, 49, 41, 1024, 2048), 64 * 2**20, 4),
    ((4, 37, 21, 256, 512), 4 * 2**20, 2),
    ((2, 11, 101, 200, 300), 2 * 2**20, 2),             # U1 past 96, V off 8
    ((3, 13, 9, 96, 40), 40_000, 6),      # one group a chunk
    ((1, 1, 2, 8, 5), kj.DW_SCRATCH_CAP, 1),
])
def test_dx_plan_covers_frame_groups_once_under_cap(shape, cap, chunks):
    n, t, u1, j, v = shape
    plan = kj.dx_plan(n, t, u1, j, v, cap=cap)
    assert len(plan.chunks) == chunks
    assert plan.ntb == -(-t // kj.DX_FRAMES) and plan.nub == -(-u1 // kj.DX_LABELS)
    assert plan.jp % 64 == 0 and plan.jp >= j and plan.vp % 8 == 0 and plan.vp >= v
    seen = np.zeros(plan.rows, np.int64)
    g_next = r_next = 0
    for g0, groups, r0, rc in plan.chunks:
        assert (g0, r0) == (g_next, r_next) and 0 < groups <= plan.groups_per_chunk
        assert r0 % u1 == 0 and rc % u1 == 0   # whole frames
        assert (r0 // u1) % t % kj.DX_FRAMES == 0  # at a frame group's start
        assert rc <= plan.chunk_rows
        seen[r0:r0 + rc] += 1
        g_next, r_next = g0 + groups, r0 + rc
    assert g_next == n * plan.ntb and r_next == plan.rows and (seen == 1).all()
    row_bytes = 2 * (plan.jp + plan.vp)
    assert plan.chunk_rows * row_bytes <= cap
    assert plan.partial_bytes == 4 * j * (plan.nub * n * t + plan.ntb * n * u1)


def test_dx_plan_raises_below_one_group():
    with pytest.raises(ValueError, match="holds no frame group"):
        kj.dx_plan(16, 49, 41, 1024, 2048, cap=2**20)


@pytest.mark.parametrize("shape,w_dtype,tol", [
    ((3, 13, 9, 24, 40), "float32", 1e-5),      # golden-like
    ((2, 37, 21, 40, 300), "float32", 1e-5),    # several frame/label blocks, V tiles
    ((2, 20, 35, 24, 37), "bfloat16", 1e-3),    # V off 8
], ids=["golden", "blocks", "bf16"])
def test_dx_chunked_twin_matches_unchunked_and_jax(shape, w_dtype, tol):
    """With F's lse. Float32 W_out: the same float32 sums in another order
    (1e-5 of each output's largest entry). bf16 W_out against JAX: 1e-3
    of the largest entry, as for H (an order difference can flip one
    bf16 rounding of dlogits)."""
    n, t, u1, j, v = shape
    arrays = _joint_inputs(n, t, u1, j, v, seed=9)
    x = [torch.from_numpy(a) for a in arrays]
    x[2] = x[2].to(getattr(torch, w_dtype))
    lse = kj.joint_lp_fwd_reference(*x[:5])[2]
    plan = kj.dx_plan(n, t, u1, j, v, cap=kj.DW_SCRATCH_CAP)
    got = kj.joint_lp_dx_chunked_reference(*x, lse, plan)
    whole = kj.joint_lp_dx_reference(*x, lse)
    for a, b in zip(got, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * max(1.0, float(b.abs().max())))
    grads = joint_lp_bwd_pallas(*(jnp.asarray(a) for a in arrays), 0,
                                interpret=True, w_dtype=getattr(jnp, w_dtype))
    for a, b in zip(got[:2], grads[:2]):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=tol * float(np.abs(b).max()))


@pytest.mark.parametrize("shape,cap,chunks", [
    ((16, 49, 41, 1024, 2048), kj.DW_SCRATCH_CAP, 1),   # the main path: one chunk
    ((16, 49, 41, 1024, 2048), 64 * 2**20, 2),
    ((4, 37, 21, 256, 512), 2**20, 2),
    ((2, 11, 101, 200, 300), 400_000, 6),             # V off 8: W_out padded
    ((3, 13, 9, 24, 40), 20_000, 3),                  # golden-like, 351 rows
    ((1, 1, 2, 8, 5), kj.DW_SCRATCH_CAP, 1),          # a single short chunk
])
def test_lp_plan_covers_rows_once_under_cap(shape, cap, chunks):
    n, t, u1, j, v = shape
    plan = kj.lp_plan(n, t, u1, j, v, cap=cap)
    assert len(plan.chunks) == chunks and plan.rows == n * t * u1
    assert plan.chunk_rows % kj.DW_TILE == 0
    assert plan.jp % 64 == 0 and plan.jp >= j and plan.vp % 8 == 0 and plan.vp >= v
    assert plan.vtiles == -(-v // kj.DW_TILE)
    seen = np.zeros(plan.rows, np.int64)
    expect = 0
    for r0, rc in plan.chunks:
        assert r0 == expect and 0 < rc <= plan.chunk_rows  # in order, no gap
        seen[r0:r0 + rc] += 1
        expect = r0 + rc
    assert expect == plan.rows and (seen == 1).all()
    assert plan.scratch_bytes <= cap
    # what the wrapper allocates is what the plan counts: w(h) in bf16,
    # the (max, sum) partials and the two picks in float32, W_out padded
    allocated = (plan.chunk_rows * plan.jp * 2 + 2 * plan.vtiles * plan.chunk_rows * 4
                 + 2 * plan.chunk_rows * 4 + (j * plan.vp * 2 if v % 8 else 0))
    assert allocated == plan.scratch_bytes


def test_lp_plan_raises_below_one_tile():
    # a row at the main shape: 2 jp + 8 vtiles + 8 = 2,184 bytes
    with pytest.raises(ValueError, match="holds no 128-row chunk"):
        kj.lp_plan(16, 49, 41, 1024, 2048, cap=128 * 2184 - 1)
    kj.lp_plan(16, 49, 41, 1024, 2048, cap=128 * 2184)


@pytest.mark.parametrize("shape,w_dtype,cap,tol", [
    ((3, 13, 9, 24, 40), "float32", 20_000, 1e-5),     # golden-like, 3 chunks
    ((2, 11, 21, 40, 300), "float32", 50_000, 1e-5),   # V tiles 128, 128, 44
    ((2, 20, 35, 24, 37), "bfloat16", 30_000, 2e-4),   # V off 8
], ids=["golden", "vtiles", "bf16"])
def test_fwd_chunked_twin_matches_unchunked_and_jax(shape, w_dtype, cap, tol):
    """The tile fold's lse within 1e-6 of logsumexp (float32: the same
    float32 sums in another order, lse ~ 4-6 here); lp_blank and
    lp_emit within the lp tolerances of tests/test_torch_joint_lp.py of
    the unchunked twin and of JAX's kernel, with a -1-padded label row."""
    n, t, u1, j, v = shape
    arrays = list(_joint_inputs(n, t, u1, j, v, seed=10)[:5])
    arrays[4][-1, u1 // 2:] = -1
    x = [torch.from_numpy(a) for a in arrays]
    x[2] = x[2].to(getattr(torch, w_dtype))
    plan = kj.lp_plan(n, t, u1, j, v, cap=cap)
    assert len(plan.chunks) > 1
    got = kj.joint_lp_fwd_chunked_reference(*x, plan)
    whole = kj.joint_lp_fwd_reference(*x)
    np.testing.assert_allclose(got[2].numpy(), whole[2].numpy(), rtol=0, atol=1e-6)
    want = joint_lp_fwd_pallas(*(jnp.asarray(a) for a in arrays), 0,
                               interpret=True, w_dtype=getattr(jnp, w_dtype))
    for a, b, r in zip(got[:2], whole[:2], want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0, atol=tol)


# C (int8 R, r_itemsize 1) and D (bf16 R 2, float32 R 4) share fwd_plan
# with the sequence kernel A/B: the same partition, their own k granule,
# row stride and shared memory (csrc/lstm_persistent.cuh)
FWD_KINDS = {"int8": 1, "bf16": 2, "float32": 4}


@pytest.mark.parametrize("kind", list(FWD_KINDS))
@pytest.mark.parametrize("n,h", [(16, 1024), (8, 96), (13, 100), (64, 1024),
                                 (300, 1024)])
def test_int8_and_train_fwd_plans_partition_units_once(n, h, kind):
    size = FWD_KINDS[kind]
    plan = klstm.fwd_plan(n, h, 132, size)
    assert plan.r_itemsize == size
    assert plan.grid <= 132 and plan.units % 8 == 0
    assert plan.kw in (1, 2, 4, 8, 16)
    owned = np.zeros(h, np.int64)
    for b in range(plan.grid):
        for j in plan.units_of(b):
            owned[j] += 1
    assert (owned == 1).all()
    assert n * plan.units <= klstm.SEQ_MAXC * klstm.SEQ_THREADS
    assert plan.smem == klstm.fwd_smem_bytes(n, plan.kp, plan.units, plan.kw,
                                             plan.resident, size) <= klstm.MAX_SMEM
    assert plan.np % 16 == 0 and plan.np >= n
    granule = 64 if size == 1 else 32  # m16n8k32 pairs of int8, else 32 k
    assert plan.kp % granule == 0 and h <= plan.kp < h + granule
    # the staged row stride: 16-byte rows, and the eight rows a quarter
    # warp reads start in distinct bank groups
    row_bytes = plan.rstride * (2 if size == 2 else 4)
    assert row_bytes % 16 == 0 and row_bytes % 128 in (16, 64)
    assert plan.rstride * (4 if size == 1 else 1) >= plan.kp


@pytest.mark.parametrize("kind", ["int8", "float32"])
@pytest.mark.parametrize("h", [96, 1024])
@pytest.mark.parametrize("n", [1, 8, 300, 512, 513, 600, 1024])
def test_batch_slices_cover_rows_under_int8_and_train_plans(n, h, kind):
    size = FWD_KINDS[kind]
    slices = klstm.batch_slices(n, klstm.fwd_plan, h, 132, size)
    assert _covers_once(n, slices)
    for _, rows in slices:
        klstm.fwd_plan(rows, h, 132, size)
    assert len(slices) == -(-n // slices[0][1])


def test_int8_and_train_fwd_plans_main_path_keep_r_slice_resident():
    # C at N 16, H 1024: 32 gate columns of 1024 int8 k (32 KB and
    # padding) plus the int32 partials and the rows' scales
    c = klstm.fwd_plan(16, 1024, 132, 1)
    assert (c.grid, c.units, c.kw, c.resident) == (128, 8, 16, True)
    assert 32 * 1024 < c.smem <= 72 * 1024
    assert klstm.batch_slices(16, klstm.fwd_plan, 1024, 132, 1) == [(0, 16)]
    assert klstm.batch_slices(600, klstm.fwd_plan, 1024, 132, 1) == [(0, 512),
                                                                     (512, 88)]
    # golden int8 encoder (N 8, H 96): 12 blocks, resident
    golden = klstm.fwd_plan(8, 96, 132, 1)
    assert (golden.grid, golden.resident) == (12, True)
    # D at N 16, H 1024, bf16 R: kernel B's plan
    assert klstm.fwd_plan(16, 1024, 132, 2) == klstm.fwd_plan(16, 1024, 132)
    # D's float32 R up to the route's 9 MiB budget (H 768): 32 columns of
    # 768 float32 (96 KB) resident; the small model's H 64 too
    f32 = klstm.fwd_plan(16, 768, 132, 4)
    assert (f32.grid, f32.units, f32.resident) == (96, 8, True)
    assert 32 * 768 * 4 < f32.smem <= 140 * 1024
    assert klstm.fwd_plan(16, 64, 132, 4).resident


@pytest.mark.parametrize("kind,h", [("int8", 4096), ("float32", 2048),
                                    ("bfloat16", 2048), ("float32", 5216),
                                    ("int8", 4990)])
def test_int8_and_train_fwd_plans_read_r_from_l2_past_the_resident_range(kind, h):
    size = {"int8": 1, "bfloat16": 2, "float32": 4}[kind]
    plan = klstm.fwd_plan(16, h, 132, size)
    assert not plan.resident
    assert klstm.fwd_smem_bytes(16, plan.kp, plan.units, 1, True, size) > klstm.MAX_SMEM


@pytest.mark.parametrize("kind", list(FWD_KINDS))
@pytest.mark.parametrize("n,h,match", [
    (513, 1024, "epilogue"),        # above 8 x 512 (row, unit) owners
    (16, 8200, "exceeds"),          # above the kernels' widest H
])
def test_int8_and_train_fwd_plans_raise_where_they_cannot_run(n, h, match, kind):
    with pytest.raises(ValueError, match=match):
        klstm.fwd_plan(n, h, 132, FWD_KINDS[kind])


def _s8(word):
    """The four signed bytes of int32 words, byte i at bits 8i."""
    w = np.asarray(word, np.int64) & 0xFFFFFFFF
    return np.stack([((w >> (8 * i)) & 0xFF).astype(np.int8) for i in range(4)],
                    -1).astype(np.int64)


def _mma_m16n8k32(a, b):
    """mma.sync.m16n8k32.row.col.s32.s8.s8 from its register fragments
    (PTX ISA): a[lane] = 4 words, b[lane] = 2 words; lane = 4 g + c.
    A word holds 4 consecutive k: a0 (row g, k 4c), a1 (row g + 8, k 4c),
    a2 (row g, k 16 + 4c), a3 (row g + 8, k 16 + 4c); b0 (column g, k 4c),
    b1 (column g, k 16 + 4c). Returns the [16, 8] int product."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, c = divmod(lane, 4)
        for reg, (row, k0) in enumerate([(g, 4 * c), (g + 8, 4 * c),
                                         (g, 16 + 4 * c), (g + 8, 16 + 4 * c)]):
            A[row, k0:k0 + 4] = _s8(a[lane][reg])
        for reg, k0 in enumerate([4 * c, 16 + 4 * c]):
            B[k0:k0 + 4, g] = _s8(b[lane][reg])
    return A @ B


def test_int8_kernel_permuted_fragments_sum_to_the_exact_product():
    """Kernel C's product (csrc/lstm_seq_int8.cu:product_int8) on its
    fragments: thread (g, c) quantizes k 16c .. 16c + 15 of a 64-k slab of
    rows g and g + 8 into 4 words, loads the same 16 k of column g as 4
    pack_k4 words staged k along a row, and feeds words (0, 1) and (2, 3)
    to two m16n8k32 products. Over every slab and 8-column tile of a
    block, read back through the accumulator layout (tile_slot), the int32
    sums equal hq @ rq exactly: padding rows (N 13 of 16) and k past H
    (100 of kp 128) included."""
    from libreasr_tpu_torch.ops.quant import quantize

    n, h, units, block = 13, 100, 8, 1
    rng = np.random.default_rng(3)
    r = quantize(torch.tensor(rng.standard_normal((h, 4 * h)) / np.sqrt(h),
                              dtype=torch.float32))
    x = torch.tensor(rng.standard_normal((n, h)), dtype=torch.float32)
    x[2] = 0.0  # a zero row: hscale 1e-12, hq 0
    hq = quantize(x.t()).q.t().numpy().astype(np.int64)  # per-row scale
    plan = klstm.fwd_plan(n, h, 132, 1)
    kp, np_ = plan.kp, plan.np
    xq = np.zeros((np_, kp), np.int64)
    xq[:n, :h] = hq
    packed = klstm.pack_k4(r.q).numpy()  # [ceil(H/4), 4H]
    # the block's staged columns: cc = gate * u + jj is column gate H + j
    j0 = block * units
    cols = [gate * h + j0 + jj for gate in range(4) for jj in range(units)]
    rs = np.zeros((4 * units, kp // 4), np.int64)
    rs[:, :packed.shape[0]] = packed[:, cols].T

    def words(row_vals):
        v = (row_vals.reshape(-1, 4) & 0xFF) << (8 * np.arange(4))
        return v.sum(-1)

    red = np.zeros((np_ // 16, units // 2, 128), np.int64)
    for mt in range(np_ // 16):
        for nt in range(units // 2):
            acc = np.zeros((16, 8), np.int64)
            for s in range(kp // 64):
                a1, a2, b1, b2 = [], [], [], []
                for lane in range(32):
                    g, c = divmod(lane, 4)
                    k0 = 64 * s + 16 * c
                    lo = words(xq[mt * 16 + g, k0:k0 + 16])
                    hi = words(xq[mt * 16 + g + 8, k0:k0 + 16])
                    bw = rs[nt * 8 + g, 16 * s + 4 * c:16 * s + 4 * c + 4]
                    a1.append((lo[0], hi[0], lo[1], hi[1]))
                    a2.append((lo[2], hi[2], lo[3], hi[3]))
                    b1.append((bw[0], bw[1]))
                    b2.append((bw[2], bw[3]))
                acc += _mma_m16n8k32(a1, b1) + _mma_m16n8k32(a2, b2)
            # the accumulator layout: lane (g, c) holds rows g, g + 8 of
            # columns 2c, 2c + 1
            for lane in range(32):
                g, c = divmod(lane, 4)
                red[mt, nt, lane * 4:lane * 4 + 4] = [
                    acc[g, 2 * c], acc[g, 2 * c + 1],
                    acc[g + 8, 2 * c], acc[g + 8, 2 * c + 1]]
    want = hq @ r.q.numpy().astype(np.int64)[:, cols]
    got = np.zeros_like(want)
    for b in range(n):
        for cc in range(4 * units):
            rr, c8 = b % 16, cc % 8
            slot = ((rr % 8) * 4 + c8 // 2) * 4 + (rr // 8) * 2 + c8 % 2
            got[b, cc] = red[b // 16, cc // 8, slot]
    np.testing.assert_array_equal(got, want)
    assert np.abs(want).max() <= 127 ** 2 * h
