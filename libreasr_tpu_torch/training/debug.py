"""Debugging and profiling tools (the JAX package's training/debug.py).

- `activation_stats`: mean, std, absmax and a NaN flag of every module's
  output in one forward pass, through forward hooks. A module's key is
  its flax intermediates path, `encoder/rnn_stack/layer0/__call__`, and
  the root's `__call__`; where an output holds several tensors, the last
  floating one gives the numbers, as in JAX.
- `param_stats`: shape, mean and std of every floating parameter, keyed
  by its torch name (the flax path with dots, convert.py).
- `perf_trace`: a torch.profiler trace of a region, written as a Chrome
  trace into a log directory; the program's telemetry spans
  (libreasr_tpu_torch.telemetry) record while it runs, as ranges in it.
- `enable_nan_debugging`: the first NaN a module outputs raises, and
  autograd's anomaly mode names the backward op that made one.

Statistics are computed in numpy on a host copy, with the JAX tools'
formulas (float32 arrays, numpy's mean and std).
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch


def _float_leaves(out):
    """The floating tensors of a module's output, in order."""
    if isinstance(out, torch.Tensor):
        return [out] if out.is_floating_point() else []
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _float_leaves(o)]
    return []


def _stats(t: torch.Tensor) -> dict:
    a = t.detach().float().cpu().numpy()
    return {"mean": float(a.mean()), "std": float(a.std()),
            "absmax": float(np.abs(a).max()) if a.size else 0.0,
            "nan": bool(np.isnan(a).any())}


def activation_stats(model: torch.nn.Module, *args, method=None,
                     **kwargs) -> dict[str, dict]:
    """Run `model(*args, **kwargs)`, or `method(*args, **kwargs)` (e.g.
    model.encode), without gradients, and return each called module's
    output statistics by its flax intermediates path."""
    stats: dict[str, dict] = {}
    handles = []
    for name, mod in model.named_modules():
        key = (name.replace(".", "/") + "/" if name else "") + "__call__"

        def hook(_mod, _inp, out, key=key):
            leaves = _float_leaves(out)
            if leaves:
                stats[key] = _stats(leaves[-1])

        handles.append(mod.register_forward_hook(hook))
    try:
        with torch.no_grad():
            (method or model)(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    return stats


def param_stats(model: torch.nn.Module) -> dict[str, dict]:
    """Shape, mean and std of every floating parameter, by name."""
    out = {}
    for name, t in model.named_parameters():
        if not t.is_floating_point():
            continue
        a = t.detach().float().cpu().numpy()
        out[name] = {"shape": list(a.shape), "mean": float(a.mean()),
                     "std": float(a.std())}
    return out


@contextlib.contextmanager
def perf_trace(logdir: str = "tmp/torch-trace"):
    """Profile a region, `with perf_trace(d): learner.step(b)`: the host
    and, where there is a card, its kernels, written to
    <logdir>/trace.json (chrome://tracing, Perfetto)."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_NAN_HOOK = None


def _raise_on_nan(mod, _inp, out):
    for t in _float_leaves(out):
        if torch.isnan(t).any():
            raise FloatingPointError(
                f"NaN in the output of {type(mod).__name__}")


def enable_nan_debugging(enable: bool = True) -> None:
    """Make the first NaN raise: every module's output is checked (a
    host sync per module, for debugging runs only), and autograd's
    anomaly mode raises in the backward op that makes one."""
    global _NAN_HOOK
    torch.autograd.set_detect_anomaly(enable)
    if _NAN_HOOK is not None:
        _NAN_HOOK.remove()
        _NAN_HOOK = None
    if enable:
        _NAN_HOOK = torch.nn.modules.module.register_module_forward_hook(
            _raise_on_nan)
