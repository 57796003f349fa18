"""The LSTM kernels against the scan cells on the card (the JAX package's
scripts/bench_pallas.py), at the flagship encoder's width.

The scan cell (ops/rnn.py:lstm_scan) launches a step's product and
gates from the host every timestep; kernel A (ops/kernels/lstm.py:
lstm_seq, through lstm_pack, csrc/lstm_seq.cu) runs the whole recurrence
in one cooperative launch with R held in bf16. This script times both at
H 1024 across batch sizes N and sequence lengths T and prints a markdown
table; `--train` times forward + backward of the scan under autograd
against kernels D and E (ops/kernels/lstm_train.py:lstm_pack_train).

Times are CUDA events around k chained calls (each fed the one before),
per call, the median of `--reps`.

Usage: python -m libreasr_tpu_torch.scripts.bench_pallas [--quick] [--train]

Runs on the card and raises without one.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def chain(step_fn, k: int):
    """A runner of k applications of step_fn(x, s, p) -> y, each fed the
    one before ([N, T, H] in and out: I == H here)."""

    def run(x, s, p):
        for _ in range(k):
            x = step_fn(x, s, p)
        return x

    return run


def timeit(step_fn, x, s, p, k=8, reps=5):
    """Seconds per call: CUDA events around k chained calls, after one
    warm call, the median of `reps`. Returns (seconds, None)."""
    run = chain(step_fn, k)
    step_fn(x, s, p)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        run(x, s, p)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / k / 1e3)
    return float(np.median(times)), None


def _setup(args):
    """(device, LSTM parameters at I == H == --hidden, numpy rng). The
    parameters are seeded uniform in +-1/sqrt(H), float32."""
    from .. import resolve_device
    from ..ops.rnn import LSTMParams

    dev = resolve_device(None)
    print(f"device: {torch.cuda.get_device_name(dev)}")
    h = args.hidden
    g = torch.Generator().manual_seed(0)
    bound = 1.0 / np.sqrt(h)

    def u(*shape):
        return ((torch.rand(shape, generator=g) * 2 - 1) * bound).to(dev)

    return dev, LSTMParams(u(h, 4 * h), u(h, 4 * h), u(4 * h)), \
        np.random.default_rng(0)


def _inputs(rng, n, t, h, dev):
    x = torch.from_numpy(rng.standard_normal((n, t, h)).astype(np.float32)).to(dev)
    zeros = torch.zeros((n, h), device=dev)
    return x, (zeros, zeros)


def train_main(args):
    """fwd+bwd per layer: the scan under autograd against kernels D and
    E. The chained step maps x -> dx (same shape), with the weight grads
    kept alive through an epsilon-weighted sum."""
    from ..ops import rnn
    from ..ops.kernels.lstm_train import lstm_pack_train

    dev, params, rng = _setup(args)
    h = args.hidden

    def mk(fn):
        def step(x, s, p):
            x = x.detach().requires_grad_()
            leaves = [t.detach().requires_grad_() for t in p]
            y = fn(x, s, rnn.LSTMParams(*leaves))
            dx, *dp = torch.autograd.grad(y.sum(), [x, *leaves])
            keep = sum(d.sum() for d in dp)
            return dx + 1e-30 * keep

        return step

    scan_train = mk(lambda x, s, p: rnn.lstm_scan(
        x, s, p, training=True, compute_dtype=torch.bfloat16)[0])
    kernel_train = mk(lambda x, s, p: lstm_pack_train(
        x, s, p, None, compute_dtype=torch.bfloat16)[0])

    shapes = [(8, 500), (32, 250), (64, 100), (64, 500)]
    if not args.quick:
        shapes += [(8, 2000), (128, 250), (256, 100)]
    rows = []
    print("\n| N | T | scan fwd+bwd | kernels D+E fwd+bwd | speedup |")
    print("|---|---|---|---|---|")
    for n, t in shapes:
        x, state = _inputs(rng, n, t, h, dev)
        ts, _ = timeit(scan_train, x, state, params, args.k, args.reps)
        tk, _ = timeit(kernel_train, x, state, params, args.k, args.reps)
        print(f"| {n} | {t} | {ts*1e3:.2f} ms | {tk*1e3:.2f} ms "
              f"| {ts/tk:.2f}x |")
        rows.append((n, t, ts, tk))

    # gradient sanity at one shape (scan f32 as the oracle)
    n, t = 8, 100
    x, state = _inputs(rng, n, t, h, dev)

    def gx(fn):
        xx = x.detach().requires_grad_()
        return torch.autograd.grad(fn(xx, state, params)[0].sum(), xx)[0]

    g_ref = gx(lambda x, s, p: rnn.lstm_scan(x, s, p))
    g_k = gx(lambda x, s, p: lstm_pack_train(
        x, s, p, None, compute_dtype=torch.bfloat16))
    err = float((g_ref - g_k).abs().max())
    rel = err / float(g_ref.abs().max())
    print(f"\nmax |dx_scan_f32 - dx_kernels| @ N={n},T={t}: {err:.2e} "
          f"(rel {rel:.2e}; bf16 R in the kernels)")
    return {"rows": rows, "max_err": err, "rel_err": rel}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--train", action="store_true",
                    help="benchmark fwd+bwd (training) instead of encode")
    ap.add_argument("--k", type=int, default=8, help="chained calls")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if args.train:
        return train_main(args)

    from ..ops import rnn
    from ..ops.kernels.lstm import lstm_pack

    dev, params, rng = _setup(args)
    h = args.hidden

    shapes = [(8, 500), (64, 100), (64, 500), (256, 100)]
    if not args.quick:
        shapes += [(8, 2000), (256, 500), (512, 100), (64, 1)]

    def scan_f32(x, s, p):
        return rnn.lstm_scan(x, s, p)[0]

    def scan_bf16(x, s, p):
        return rnn.lstm_scan(x, s, p, compute_dtype=torch.bfloat16)[0]

    def kernel(x, s, p):
        return lstm_pack(x, s, p)[0]

    rows = []
    print("\n| N | T | scan f32 | scan bf16 | kernel A | kernel vs f32 |")
    print("|---|---|---|---|---|---|")
    with torch.no_grad():
        for n, t in shapes:
            x, state = _inputs(rng, n, t, h, dev)
            tf32, _ = timeit(scan_f32, x, state, params, args.k, args.reps)
            tbf16, _ = timeit(scan_bf16, x, state, params, args.k, args.reps)
            tk, _ = timeit(kernel, x, state, params, args.k, args.reps)
            print(f"| {n} | {t} | {tf32*1e3:.2f} ms | {tbf16*1e3:.2f} ms "
                  f"| {tk*1e3:.3f} ms | {tf32/tk:.2f}x |")
            rows.append((n, t, tf32, tbf16, tk))

        # numeric sanity at one shape
        n, t = 8, 100
        x, state = _inputs(rng, n, t, h, dev)
        err = float((scan_f32(x, state, params)
                     - kernel(x, state, params)).abs().max())
    print(f"\nmax |scan_f32 - kernel| @ N={n},T={t}: {err:.2e} "
          "(bf16 R in the kernel)")
    return {"rows": rows, "max_err": err}


if __name__ == "__main__":
    main()
