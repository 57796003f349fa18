"""The plain twins of the joint kernels F, G, H
(ops/kernels/joint_lp.py, which the wrappers take for CPU tensors)
against the JAX package's Pallas kernels run in interpret mode
(joint_lp_fwd_pallas, joint_lp_bwd_pallas), with float32 and bf16
W_out, odd J, V, T and U1 and a label equal to the blank. JAX's kernels
take U1 up to 96 only; a longer label sequence is held against JAX's
chunked XLA path (fused_loss._all_lp and its vjp, with identity
projections so that its inputs are the projections themselves).

Tolerances: float32 W_out, the same float32 sums in another order:
lp 1e-5, gradients 1e-5 of their largest entry. bf16 W_out: both round
h and dlogits to bf16 for the products; an order difference of an ulp
can flip one rounding (2**-9 of the value): lp 2e-4, gradients 1e-3 of
their largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libreasr_tpu.ops import fused_loss as jfl
from libreasr_tpu.ops.pallas.joint_lp import joint_lp_bwd_pallas, joint_lp_fwd_pallas
from libreasr_tpu_torch.ops.kernels import joint_lp as kj

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-4, 1e-3)}


def _inputs(n, t, u1, j, v, seed):
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


def _twins(enc, pred, w, b, lab, gb, ge, w_dtype):
    t = [torch.from_numpy(a) for a in (enc, pred, w, b, lab, gb, ge)]
    t[2] = t[2].to(getattr(torch, w_dtype))
    lpb, lpe = kj.joint_lp_fwd(*t[:5])
    d_enc, d_pred, lse = kj.joint_lp_dx(*t)
    dw, db = kj.joint_lp_dw(*t, lse)
    return [x.float().numpy() for x in (lpb, lpe, d_enc, d_pred, dw, db)]


def _check(got, want, w_dtype):
    lp_tol, g_tol = TOL[w_dtype]
    names = ("lp_blank", "lp_emit", "d_enc_proj", "d_pred_proj", "d_w_out", "d_b_out")
    for name, a, b in zip(names, got, want):
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape, name
        tol = lp_tol if name.startswith("lp") else g_tol * float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 11, 9, 24, 40), (3, 5, 13, 40, 37)],
                         ids=["golden-like", "odd"])
def test_twins_match_interpret_pallas(shape, w_dtype):
    enc, pred, w, b, lab, gb, ge = _inputs(*shape, seed=sum(shape))
    jd = getattr(jnp, w_dtype)
    args = [jnp.asarray(a) for a in (enc, pred, w, b, lab)]
    lpb, lpe = joint_lp_fwd_pallas(*args, 0, interpret=True, w_dtype=jd)
    grads = joint_lp_bwd_pallas(*args, jnp.asarray(gb), jnp.asarray(ge), 0,
                                interpret=True, w_dtype=jd)
    _check(_twins(enc, pred, w, b, lab, gb, ge, w_dtype),
           [lpb, lpe, *grads], w_dtype)


def test_twins_match_chunked_path_past_u1_96():
    """U1 101 (JAX's kernels stop at 96): the JAX chunked path with
    identity projections, float32."""
    n, t, u1, j, v = 2, 7, 101, 16, 29
    enc, pred, w, b, lab, gb, ge = _inputs(n, t, u1, j, v, seed=3)
    eye = jnp.eye(j, dtype=jnp.float32)

    def lp(e, p, w_out, b_out):
        jp = jfl.JointParams(eye, jnp.zeros(j), eye, w_out, b_out)
        return jfl._all_lp(e, p, jp, jnp.asarray(lab), 0, t)

    (lpb, lpe), vjp = jax.vjp(lp, *(jnp.asarray(a) for a in (enc, pred, w, b)))
    grads = vjp((jnp.asarray(gb), jnp.asarray(ge)))
    _check(_twins(enc, pred, w, b, lab, gb, ge, "float32"),
           [lpb, lpe, *grads], "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cap", [
    ((3, 13, 9, 96, 40), kj.DW_SCRATCH_CAP),          # one chunk of 351 rows
    ((2, 11, 101, 200, 300), kj.DW_SCRATCH_CAP),      # V off 8, row groups
    ((4, 37, 21, 256, 512), 4 * 2**20),               # five chunks
], ids=["golden-like", "odd", "chunked"])
def test_dw_tensor_core_kernel_matches_twin_on_cuda(shape, cap):
    """Kernel H with bf16 W_out (TMA + wgmma, over the rows in chunks)
    against its twin, within chip_smoke.py's JOINT_GRAD_TOL (2e-3 of each
    output's largest entry: summation order and the bf16 flips of
    dlogits it can cause); twice on the same inputs, the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    enc, pred, w, b, lab, gb, ge = _inputs(*shape, seed=sum(shape))
    x = [torch.from_numpy(a).cuda() for a in (enc, pred, w, b, lab, gb, ge)]
    x[2] = x[2].bfloat16()
    lse = kj.joint_lp_dx(*x)[2]
    before = kj.LAUNCHES["joint_lp_dw"]
    got = kj.joint_lp_dw(*x, lse, scratch_cap=cap)
    again = kj.joint_lp_dw(*x, lse, scratch_cap=cap)
    want = kj.joint_lp_dw_reference(*x, lse)
    torch.cuda.synchronize()
    assert kj.LAUNCHES["joint_lp_dw"] == before + 2
    for a, r, c in zip(got, want, again):
        assert torch.equal(a, c)
        assert float((a - r).abs().max()) <= 2e-3 * float(r.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cap", [
    ((3, 13, 9, 96, 40), kj.DW_SCRATCH_CAP),          # golden-like
    ((2, 11, 101, 200, 300), kj.DW_SCRATCH_CAP),      # U1 past 96, V off 8
    ((16, 49, 41, 1024, 2048), kj.DW_SCRATCH_CAP),    # the main path
    ((4, 37, 21, 256, 512), 4 * 2**20),               # two chunks
], ids=["golden-like", "odd", "main", "chunked"])
def test_dx_tensor_core_kernel_matches_twin_on_cuda(shape, cap):
    """Kernel G with bf16 W_out (H's TMA + wgmma engine: the lse product,
    the dlogits product, the dh product with its sums in the epilogue)
    against its twin, within chip_smoke.py's JOINT_GRAD_TOL (2e-3 of each
    gradient's largest entry) and JOINT_LP_TOL (lse, 2e-3); twice on the
    same inputs, the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    enc, pred, w, b, lab, gb, ge = _inputs(*shape, seed=sum(shape))
    x = [torch.from_numpy(a).cuda() for a in (enc, pred, w, b, lab, gb, ge)]
    x[2] = x[2].bfloat16()
    before = kj.LAUNCHES["joint_lp_dx"]
    got = kj.joint_lp_dx(*x, scratch_cap=cap)
    again = kj.joint_lp_dx(*x, scratch_cap=cap)
    want = kj.joint_lp_dx_reference(*x)
    torch.cuda.synchronize()
    assert kj.LAUNCHES["joint_lp_dx"] == before + 2
    for i, (a, r, c) in enumerate(zip(got, want, again)):
        assert torch.equal(a, c)
        tol = 2e-3 if i == 2 else 2e-3 * float(r.abs().max())
        assert float((a - r).abs().max()) <= tol
