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
than SMs, and raise where R's slice cannot fit.

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

from libreasr_tpu.ops.pallas.joint_lp import joint_lp_bwd_pallas
from libreasr_tpu_torch.ops.kernels import joint_lp as kj
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
    _, _, lse = kj.joint_lp_dx_reference(*x)
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
    _, _, lse = kj.joint_lp_dx_reference(*x)
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
