"""The port's RNN-T loss (ops/rnnt_loss.py) against the JAX package's
`rnnt_loss` and against the port's own cell-by-cell oracle
`rnnt_loss_naive`, on logits made with numpy.

Tolerances: both sides compute the same float32 log-space DP; the port
runs it over anti-diagonals, JAX as a scan over t of associative scans
over u, so the logaddexp sums are taken in another order: ~1e-6
relative on the loss (bound 1e-5), and on the logits' gradient (values
within [-1, 1]) 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libreasr_tpu.ops import rnnt_loss as jrl
from libreasr_tpu_torch.ops import rnnt_loss as trl

CASES = [
    # n, t, u, v, frame lengths, label lengths
    (4, 7, 5, 6, [7, 1, 5, 6], [5, 0, 3, 2]),
    (3, 12, 9, 11, [12, 12, 3], [9, 4, 9]),
    (2, 1, 3, 5, [1, 1], [0, 3]),
    (2, 9, 0, 4, [9, 4], [0, 0]),
]


def _inputs(case, seed):
    n, t, u, v, fl, yl = case
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, t, u + 1, v)) * 2).astype(np.float32)
    lab = rng.integers(0, v, (n, u)).astype(np.int32)
    return x, lab, np.array(fl), np.array(yl)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"n{c[0]}t{c[1]}u{c[2]}")
def test_loss_and_gradient_match_jax(case):
    x, lab, fl, yl = _inputs(case, sum(case[:4]))
    w = np.linspace(0.5, 1.5, x.shape[0]).astype(np.float32)

    def jloss(a):
        return jnp.sum(jrl.rnnt_loss(a, jnp.asarray(lab), jnp.asarray(fl),
                                     jnp.asarray(yl)) * w)

    jl = jrl.rnnt_loss(jnp.asarray(x), jnp.asarray(lab), jnp.asarray(fl),
                       jnp.asarray(yl))
    jg = jax.grad(jloss)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    tl = trl.rnnt_loss(xt, torch.from_numpy(lab), torch.from_numpy(fl),
                       torch.from_numpy(yl))
    (tl * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", CASES[:3], ids=lambda c: f"n{c[0]}t{c[1]}u{c[2]}")
def test_matches_naive_oracle(case):
    """The diagonal DP and its analytic gradient against autograd through
    the cell-by-cell DP."""
    x, lab, fl, yl = _inputs(case, 100 + sum(case[:4]))
    args = (torch.from_numpy(lab), torch.from_numpy(fl), torch.from_numpy(yl))
    a = torch.tensor(x, requires_grad=True)
    b = torch.tensor(x, requires_grad=True)
    la, lb = trl.rnnt_loss(a, *args), trl.rnnt_loss_naive(b, *args)
    la.sum().backward()
    lb.sum().backward()
    np.testing.assert_allclose(la.detach().numpy(), lb.detach().numpy(), rtol=1e-5)
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=0, atol=1e-5)


def test_pieces_match_jax():
    """alphas, betas and occupancies themselves, where they are finite
    (cells that no path reaches hold multiples of NEG on both sides)."""
    x, lab, fl, yl = _inputs(CASES[1], 5)
    j = [jnp.asarray(a) for a in (x, lab, fl, yl)]
    t = [torch.from_numpy(a) for a in (x, lab, fl, yl)]
    jlpb, jlpe = jrl._log_probs(j[0], j[1], 0)
    jalpha, jlpe_m = jrl._forward_alphas(jlpb, jlpe, j[3])
    jbeta = jrl._backward_betas(jlpb, jlpe_m, j[2], j[3])
    jlz = jrl._terminal_gather(jalpha, jlpb, j[2], j[3])
    jocc = jrl._occupancies(jlpb, jlpe_m, jalpha, jbeta, j[2], j[3], jlz)
    tlpb, tlpe = trl.log_probs(t[0], t[1], 0)
    talpha, tlpe_m = trl.forward_alphas(tlpb, tlpe, t[3])
    tbeta = trl.backward_betas(tlpb, tlpe_m, t[2], t[3])
    tlz = trl.terminal_gather(talpha, tlpb, t[2], t[3])
    tocc = trl.occupancies(tlpb, tlpe_m, talpha, tbeta, t[2], t[3], tlz)
    for got, want in ((talpha, jalpha), (tbeta, jbeta)):
        want = np.asarray(want)
        ok = want > -1e29
        np.testing.assert_array_equal(got.numpy() > -1e29, ok)
        np.testing.assert_allclose(got.numpy()[ok], want[ok], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tlz.numpy(), np.asarray(jlz), rtol=1e-5)
    for got, want in zip(tocc, jocc):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
