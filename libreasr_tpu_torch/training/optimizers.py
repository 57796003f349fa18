"""Optimizers with optax's numerics, on lists of tensors.

The port of the JAX package's training/optimizers.py. Each optimizer is
a pair of functions like an optax GradientTransformation:
`init(params) -> state` and `update(grads, state, params) -> (updates,
state)`, where params, grads and updates are lists of tensors in one
order; `apply_updates` adds the updates to the parameters in place.
The state is plain tensors and ints, held by the caller (the Learner).

- ranger = lookahead(radam) (radam threshold 5, eps 1e-8; lookahead
  k 6, alpha 0.5), adam, adamw, sgd (momentum 0.9), each scaled by a
  learning rate or a schedule evaluated at the count of its own updates;
- clip_by_global_norm before the optimizer, MultiSteps accumulation
  (the mean of k gradients, one inner update on the k-th) after, as
  `build_optimizer` chains them;
- make_lr_schedule: optax's warmup_cosine_decay_schedule.

Scalars (bias corrections, the radam rectifier, the schedule) are
computed in float64 on the host; optax computes them in float32 on the
device, so updates agree to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch


@dataclass(frozen=True)
class Transform:
    init: Callable[[list], Any]
    update: Callable[[list, Any, list], tuple[list, Any]]


def _lr_at(lr, count: int) -> float:
    return float(lr(count)) if callable(lr) else float(lr)


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


def clip_by_global_norm(max_norm: float) -> Transform:
    def update(grads, state, params=None):
        norm = global_norm(grads)
        # optax: (t / norm) * max_norm past the limit, t itself below it
        clipped = [torch.where(norm < max_norm, g, (g / norm) * max_norm)
                   for g in grads]
        return clipped, state

    return Transform(lambda params: None, update)


def _adam_moments(grads, state, b1, b2):
    mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state["mu"])]
    nu = [(1 - b2) * g * g + b2 * v for g, v in zip(grads, state["nu"])]
    count = state["count"] + 1
    return mu, nu, count


def _zeros_state(params):
    return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
            "nu": [torch.zeros_like(p) for p in params]}


def radam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          threshold: float = 5.0) -> Transform:
    ro_inf = 2.0 / (1.0 - b2) - 1.0

    def update(grads, state, params=None):
        mu, nu, count = _adam_moments(grads, state, b1, b2)
        b2t = b2 ** count
        ro = ro_inf - 2 * count * b2t / (1 - b2t)
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        step = -_lr_at(lr, state["count"])
        if ro >= threshold:
            r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                          / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
            ups = [step * (r * (m / c1) / (torch.sqrt(v / c2) + eps))
                   for m, v in zip(mu, nu)]
        else:
            ups = [step * (m / c1) for m in mu]
        return ups, {"count": count, "mu": mu, "nu": nu}

    return Transform(_zeros_state, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Transform:
    """optax.adam, or optax.adamw with `weight_decay` (decay added to the
    scaled moments before the learning rate)."""

    def update(grads, state, params=None):
        mu, nu, count = _adam_moments(grads, state, b1, b2)
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        ups = [(m / c1) / (torch.sqrt(v / c2) + eps) for m, v in zip(mu, nu)]
        if weight_decay:
            ups = [u + weight_decay * p for u, p in zip(ups, params)]
        step = -_lr_at(lr, state["count"])
        return [step * u for u in ups], {"count": count, "mu": mu, "nu": nu}

    return Transform(_zeros_state, update)


def sgd(lr, momentum: float = 0.9) -> Transform:
    def init(params):
        return {"count": 0, "trace": [torch.zeros_like(p) for p in params]}

    def update(grads, state, params=None):
        trace = [g + momentum * t for g, t in zip(grads, state["trace"])]
        step = -_lr_at(lr, state["count"])
        return ([step * t for t in trace],
                {"count": state["count"] + 1, "trace": trace})

    return Transform(init, update)


def lookahead(inner: Transform, k: int = 6, alpha: float = 0.5) -> Transform:
    """Every k steps pull the fast weights toward the slow ones:
    slow += alpha (fast - slow); fast := slow (the JAX package's
    lookahead transform)."""

    def init(params):
        return {"inner": inner.init(params), "count": 0,
                "slow": [p.detach().clone() for p in params]}

    def update(grads, state, params):
        inner_ups, inner_state = inner.update(grads, state["inner"], params)
        fast = [p + u for p, u in zip(params, inner_ups)]
        count = state["count"] + 1
        slow = state["slow"]
        if count % k == 0:
            slow = [s + alpha * (f - s) for s, f in zip(slow, fast)]
            ups = [s - p for s, p in zip(slow, params)]
        else:
            ups = [f - p for f, p in zip(fast, params)]
        return ups, {"inner": inner_state, "count": count, "slow": slow}

    return Transform(init, update)


def chain(*parts: Transform) -> Transform:
    def init(params):
        return [t.init(params) for t in parts]

    def update(grads, state, params):
        new = []
        for t, s in zip(parts, state):
            grads, s = t.update(grads, s, params)
            new.append(s)
        return grads, new

    return Transform(init, update)


def multi_steps(inner: Transform, k: int) -> Transform:
    """optax.MultiSteps with use_grad_mean: gradients are averaged over k
    calls; the k-th runs one inner update on the mean and the others
    return zero updates."""

    def init(params):
        return {"inner": inner.init(params), "mini_step": 0,
                "acc": [torch.zeros_like(p) for p in params]}

    def update(grads, state, params):
        n = state["mini_step"]
        acc = [a + (g - a) / (n + 1) for g, a in zip(grads, state["acc"])]
        if n == k - 1:
            ups, inner_state = inner.update(acc, state["inner"], params)
            return ups, {"inner": inner_state, "mini_step": 0,
                         "acc": [torch.zeros_like(a) for a in acc]}
        return ([torch.zeros_like(g) for g in grads],
                {"inner": state["inner"], "mini_step": n + 1, "acc": acc})

    return Transform(init, update)


@torch.no_grad()
def apply_updates(params, updates) -> None:
    for p, u in zip(params, updates):
        p.add_(u.to(p.dtype))


_NOT_PORTED = ("ranger_adabelief", "over9000", "lamb", "apollo", "adahessian")


def build_optimizer(name: str, learning_rate, *, weight_decay: float = 0.01,
                    grad_clip: float = 10.0, accumulate: int = 1,
                    reduce_on_plateau: bool = False) -> Transform:
    """clip -> optimizer [-> MultiSteps], as the JAX package chains them."""
    name = name.lower()
    if name in _NOT_PORTED or reduce_on_plateau:
        raise NotImplementedError(
            f"libreasr_tpu_torch: optimizer {name!r}"
            f"{' with reduce_on_plateau' if reduce_on_plateau else ''} is not "
            "ported yet (ROADMAP queue 1, training part 2)")
    if name == "ranger":
        base = lookahead(radam(learning_rate))
    elif name == "adam":
        base = adam(learning_rate)
    elif name == "adamw":
        base = adam(learning_rate, weight_decay=weight_decay)
    elif name == "sgd":
        base = sgd(learning_rate, momentum=0.9)
    else:
        raise ValueError(f"unknown optimizer: {name}")
    tx = chain(clip_by_global_norm(grad_clip), base)
    return multi_steps(tx, accumulate) if accumulate > 1 else tx


def make_lr_schedule(conf_training: dict) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule from lr / 25 up to lr over
    warmup_pct of total_steps, then a cosine down to lr / 100."""
    lr = conf_training.get("lr", 5e-4)
    steps = conf_training.get("total_steps", 100_000)
    warmup = max(int(steps * conf_training.get("warmup_pct", 0.3)), 1)
    decay = max(steps, warmup + 1) - warmup
    init, end = lr / 25.0, lr / 100.0
    alpha = end / lr if lr else 0.0

    def schedule(count: int) -> float:
        if count < warmup:
            frac = 1 - min(max(count, 0), warmup) / warmup
            return (init - lr) * frac + lr
        c = min(count - warmup, decay)
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay))
                     + alpha)

    return schedule
