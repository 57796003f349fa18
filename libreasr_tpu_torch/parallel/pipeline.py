"""GPipe pipelining of a uniform [H -> H] LSTM stack over the mesh's pipe
group (the JAX package's parallel/pipeline.py), one process a stage.

The L layers split into P contiguous stages; the batch into M
microbatches. Forward (fill, then drain): stage p runs microbatch m on
its layers (the scan cells, `ops/rnn.py:lstm_scan`, as JAX's pipeline
does) once it has received it from stage p - 1, and sends the result on
to p + 1; the last stage keeps the outputs, which are then broadcast
over the pipe group, as JAX's `psum` of the last stage's outputs
replicates them. Backward: in reverse microbatch order, each stage
receives its outputs' gradient from p + 1 (the last stage takes the
broadcast output's), runs the backward of its own microbatch graph and
sends its inputs' gradient to p - 1. Each stage's parameter gradients
cover its own layers only; the input's gradient arrives on stage 0.

Learnable initial states (h0 [n_state=2, 1, H] a layer) broadcast to
each microbatch; without them the states start at zero.
"""

from __future__ import annotations

import torch

from ..ops.rnn import LSTMParams, lstm_scan


def stack_layer_params(layers: list[LSTMParams]) -> LSTMParams:
    """Per-layer LSTMParams -> one LSTMParams with a leading [L] axis."""
    return LSTMParams(*(torch.stack([getattr(l, f) for l in layers])
                        for f in LSTMParams._fields))


def _layer(params: LSTMParams, j: int) -> LSTMParams:
    return LSTMParams(*(getattr(params, f)[j] for f in LSTMParams._fields))


def check_stack(n_layers: int, n_stages: int, n: int, n_micro: int,
                in_sz: int, h: int) -> None:
    """JAX's guards, with its messages."""
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible by {n_stages} stages")
    if n % n_micro:
        raise ValueError(f"batch {n} not divisible by {n_micro} microbatches")
    if in_sz != h:
        raise ValueError("pipeline stages must be uniform [H -> H] layers; "
                         "run the input projection outside the pipeline")


def _run_stage(x, lengths, layers, h0s, compute_dtype):
    y = x
    for p, h0 in zip(layers, h0s):
        n, h = y.shape[0], y.shape[-1]
        state0 = tuple(h0[s].to(y.dtype).expand(n, h) for s in range(2))
        y, _ = lstm_scan(y, state0, p, lengths=lengths,
                         compute_dtype=compute_dtype)
    return y


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lengths, group, stage, n_stages, n_micro, ranks,
                compute_dtype, n_layers, *flat):
        import torch.distributed as dist

        per = len(LSTMParams._fields) + 1
        ws = [w.detach().requires_grad_() for w in flat]
        layers = [LSTMParams(*ws[j * per:j * per + per - 1])
                  for j in range(n_layers)]
        h0s = [ws[j * per + per - 1] for j in range(n_layers)]
        xm, lm = x.chunk(n_micro), lengths.chunk(n_micro)
        ins, outs = [], []
        for m in range(n_micro):
            if stage == 0:
                inp = xm[m].detach()
            else:
                inp = torch.empty_like(xm[m])
                dist.recv(inp, src=ranks[stage - 1], group=group)
            inp.requires_grad_()
            with torch.enable_grad():
                y = _run_stage(inp, lm[m], layers, h0s, compute_dtype).to(x.dtype)
            if stage < n_stages - 1:
                dist.send(y.detach().contiguous(), dst=ranks[stage + 1],
                          group=group)
            ins.append(inp)
            outs.append(y)
        out = (torch.cat([o.detach() for o in outs]) if stage == n_stages - 1
               else torch.empty_like(x))
        dist.broadcast(out, src=ranks[-1], group=group)
        ctx.graph = (ins, outs, ws)
        ctx.meta = (group, stage, n_stages, n_micro, ranks)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        ins, outs, ws = ctx.graph
        group, stage, n_stages, n_micro, ranks = ctx.meta
        gm = g.chunk(n_micro)
        dws = [torch.zeros_like(w) for w in ws]
        dxs = [None] * n_micro
        for m in reversed(range(n_micro)):
            if stage == n_stages - 1:
                dy = gm[m].contiguous()
            else:
                dy = torch.empty_like(outs[m])
                dist.recv(dy, src=ranks[stage + 1], group=group)
            got = torch.autograd.grad(outs[m], [ins[m]] + ws, dy,
                                      allow_unused=True)
            for i, d in enumerate(got[1:]):
                if d is not None:
                    dws[i] += d
            if stage > 0:
                dist.send(got[0].contiguous(), dst=ranks[stage - 1], group=group)
            else:
                dxs[m] = got[0]
        ctx.graph = None
        dx = torch.cat(dxs) if stage == 0 else torch.zeros_like(g)
        return (dx, None, None, None, None, None, None, None, None, *dws)


def pipeline_stage(layers: list[LSTMParams], h0s: list, x, *, mesh,
                   axis: str = "pipe", n_micro: int, lengths=None,
                   compute_dtype=None):
    """Run this rank's stage (`layers`, its share of the stack, with
    their h0 [2, 1, H]) in the pipeline over mesh[axis]. x: [N, T, H],
    read on stage 0. Returns y [N, T, H], the last stage's outputs, on
    every rank of the pipe group."""
    n, t, h = x.shape
    if n % n_micro:
        raise ValueError(f"batch {n} not divisible by {n_micro} microbatches")
    if lengths is None:  # full length, as JAX's pipeline gates
        lengths = torch.full((n,), t, dtype=torch.long, device=x.device)
    group = mesh.group(axis)
    import torch.distributed as dist

    ranks = dist.get_process_group_ranks(group)
    flat = []
    for p, h0 in zip(layers, h0s):
        flat.extend(p)
        flat.append(h0)
    return _Pipeline.apply(x, lengths, group, mesh.index(axis), mesh.size(axis),
                           n_micro, ranks, compute_dtype, len(layers), *flat)


def pipeline_lstm_stack(stacked: LSTMParams, x, *, mesh, axis: str = "pipe",
                        n_micro: int, lengths=None, compute_dtype=None,
                        h0=None, dp_axis: str | None = None):
    """Run an L-layer [H -> H] LSTM stack pipelined over mesh[axis] (a mesh
    over processes). stacked: LSTMParams with a leading [L] axis, the
    same on every rank; this rank runs its stage's L / P layers. x:
    [N, T, H], this rank's rows when the batch is data-parallel
    (`dp_axis`; the rows never leave their data slot). h0: [L, 2, 1, H]
    or None (zeros). Returns y [N, T, H] on every rank of the pipe
    group; the gradient of `stacked` on a rank covers its stage's layers
    (zeros elsewhere), so the stack's gradient is their sum over the
    pipe group."""
    n_stages = mesh.size(axis)
    n, t, h = x.shape
    n_layers = stacked.kernel.shape[0]
    check_stack(n_layers, n_stages, n, n_micro, stacked.kernel.shape[1], h)
    if h0 is None:
        h0 = torch.zeros((n_layers, 2, 1, h), dtype=x.dtype, device=x.device)
    per = n_layers // n_stages
    js = range(mesh.index(axis) * per, (mesh.index(axis) + 1) * per)
    return pipeline_stage([_layer(stacked, j) for j in js], [h0[j] for j in js],
                          x, mesh=mesh, axis=axis, n_micro=n_micro,
                          lengths=lengths, compute_dtype=compute_dtype)
