"""Products on weights held in the compute type (ops/rnn.py:_weight, _mm;
models/modules.py:Dense), as the streaming engine holds a bf16 model's
tower matrices: taken without a copy or a second cast; on the CPU the
rounded float32 product, on the card (the `cuda` case) a tensor-core
product with float32 sums and a float32 output.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from libreasr_tpu_torch.models.modules import Dense
from libreasr_tpu_torch.ops.rnn import _mm, _weight, round_to

BF16 = torch.bfloat16


class _Ops(TorchDispatchMode):
    """The aten ops a block runs."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def test_weight_in_the_compute_type_is_taken_without_a_copy():
    w = torch.randn(8, 12, generator=torch.Generator().manual_seed(0))
    wb = w.to(BF16)
    assert _weight(wb, BF16) is wb
    assert _weight(w, None) is w
    r = _weight(w, BF16)  # a float32 weight is rounded, as before
    assert r.dtype == torch.float32 and torch.equal(r, round_to(w, BF16))


def test_dense_does_not_cast_a_bf16_kernel_again():
    d = Dense(8, 6, torch.Generator().manual_seed(1), dtype=BF16)
    x = torch.randn(3, 8)
    with _Ops() as ops:
        y32 = d(x)
    casts = ops.names.count("aten._to_copy")
    assert casts == 3  # input, kernel, bias
    with torch.no_grad():
        d.kernel = torch.nn.Parameter(d.kernel.to(BF16), requires_grad=False)
        d.bias = torch.nn.Parameter(d.bias.to(BF16), requires_grad=False)
    with _Ops() as ops:
        y16 = d(x)
    assert ops.names.count("aten._to_copy") == 1  # the input only
    assert y16.dtype == BF16 and torch.equal(y16, y32)


@pytest.mark.parametrize("shape", [(5, 16), (2, 3, 16)])
def test_cpu_product_of_a_bf16_weight_is_the_rounded_product(shape):
    g = torch.Generator().manual_seed(2)
    a, w = torch.randn(shape, generator=g), torch.randn(16, 24, generator=g)
    got = _mm(a, _weight(w.to(BF16), BF16), BF16)
    assert got.dtype == torch.float32 and got.shape == shape[:-1] + (24,)
    assert torch.equal(got, _mm(a, _weight(w, BF16), BF16))


@pytest.mark.cuda
def test_tensor_core_product_sums_in_float32_on_cuda():
    """bf16 operands, float32 sums and output: within the float32
    summation bound of the exact product of the rounded operands,
    (K + 1) 2^-24 |a| |w|, at the greedy engine's widths; a bf16 output
    would not be."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in [(512, 1280, 4096), (512, 1024, 4096), (512, 1024, 3072),
                    (7, 96, 384)]:
        a = torch.randn(m, k, device="cuda", generator=g)
        w = torch.randn(k, n, device="cuda", generator=g)
        y = _mm(a, _weight(w.to(BF16), BF16), BF16)
        assert y.dtype == torch.float32
        ad, wd = round_to(a, BF16).double(), round_to(w, BF16).double()
        ref = ad @ wd
        bound = (k + 1) * 2.0 ** -24 * (ad.abs() @ wd.abs())
        assert bool(((y.double() - ref).abs() <= bound).all()), (m, k, n)
        y16 = (a.to(BF16) @ w.to(BF16)).double()
        assert not bool(((y16 - ref).abs() <= bound).all())
