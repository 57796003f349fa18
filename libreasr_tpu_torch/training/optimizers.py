"""Optimizers with optax's numerics, on lists of tensors.

The port of the JAX package's training/optimizers.py. Each optimizer is
a pair of functions like an optax GradientTransformationExtraArgs:
`init(params) -> state` and `update(grads, state, params, **extra) ->
(updates, state)`, where params, grads and updates are lists of tensors
in one order and `extra` carries the keyword arguments some transforms
read (`value`: the loss, for reduce_on_plateau; `hessian_diag`: the
Hutchinson estimate, for adahessian); `apply_updates` adds the updates
to the parameters in place. The state is plain tensors, numbers and
containers of them, held by the caller (the Learner).

- ranger = lookahead(radam) (radam threshold 5, eps 1e-8; lookahead
  k 6, alpha 0.5), ranger_adabelief = lookahead(adabelief),
  over9000 / lamb = lookahead(lamb(weight_decay)), adam, adamw, sgd
  (momentum 0.9), each scaled by a learning rate or a schedule evaluated
  at the count of its own updates, as optax's scale_by_learning_rate;
- apollo and adahessian, the JAX package's own transforms, which read
  the schedule at their count after the increment, as it does;
- clip_by_global_norm before the optimizer, reduce_on_plateau (factor
  0.5, patience 10, cooldown 5, losses averaged over 50 steps) after it,
  MultiSteps accumulation (the mean of k gradients, one inner update on
  the k-th, with the k-th call's extra arguments) around them, as
  `build_optimizer` chains them;
- warmup_cosine_decay_schedule, optax's, and make_lr_schedule, the
  training config's use of it.

On a mesh a rank may hold a column block of a tensor (the model axis)
or only its pipe stage's tensors. The Learner then passes `spread`
(a Spread) among the extra arguments, and every reduction over a whole
tensor or over all tensors (the global norm of clipping, LAMB's trust
ratio, apollo's secant sums) sums its parts over the ranks that hold
them; elementwise updates need nothing.

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


@dataclass(frozen=True)
class Spread:
    """Where the parts of a rank's tensors (by index in the parameter
    list) live: the `sharded` ones are column blocks over `model_group`;
    the `staged` ones belong to this rank's pipe stage, and the other
    stages of `pipe_group` hold the rest of the model's."""

    model_group: Any = None
    sharded: frozenset = frozenset()
    pipe_group: Any = None
    staged: frozenset = frozenset()

    @torch.no_grad()
    def tensor_sum(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """A sum over tensor i's elements, given this rank's part's."""
        if i in self.sharded and self.model_group is not None:
            return self._sum(x, self.model_group)
        return x

    @torch.no_grad()
    def total(self, sums: list) -> torch.Tensor:
        """The sum over every tensor of the model, given each of this
        rank's tensors' (part's) sum: replicated tensors once, column
        blocks over the model group, stage tensors over the pipe group."""
        zero = torch.zeros((), device=sums[0].device) if sums else torch.zeros(())
        rep = sum((s for i, s in enumerate(sums)
                   if i not in self.sharded and i not in self.staged), zero)
        parts = torch.stack([
            sum((s for i, s in enumerate(sums) if i in self.sharded), zero),
            sum((s for i, s in enumerate(sums) if i in self.staged), zero)])
        if self.model_group is not None:
            parts[0] = self._sum(parts[0], self.model_group)
        if self.pipe_group is not None:
            parts[1] = self._sum(parts[1], self.pipe_group)
        return rep + parts[0] + parts[1]

    @staticmethod
    def _sum(x, group):
        import torch.distributed as dist

        x = x.clone()
        dist.all_reduce(x, group=group)
        return x


def global_norm(tensors, spread: Spread | None = None) -> torch.Tensor:
    if spread is None:
        return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))
    return torch.sqrt(spread.total([torch.sum(t.float() * t.float())
                                    for t in tensors]))


def clip_by_global_norm(max_norm: float) -> Transform:
    def update(grads, state, params=None, *, spread=None, **extra):
        norm = global_norm(grads, spread)
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

    def update(grads, state, params=None, **extra):
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

    def update(grads, state, params=None, **extra):
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

    def update(grads, state, params=None, **extra):
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

    def update(grads, state, params, **extra):
        inner_ups, inner_state = inner.update(grads, state["inner"], params,
                                              **extra)
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

    def update(grads, state, params, **extra):
        new = []
        for t, s in zip(parts, state):
            grads, s = t.update(grads, s, params, **extra)
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

    def update(grads, state, params, **extra):
        n = state["mini_step"]
        acc = [a + (g - a) / (n + 1) for g, a in zip(grads, state["acc"])]
        if n == k - 1:
            ups, inner_state = inner.update(acc, state["inner"], params,
                                            **extra)
            return ups, {"inner": inner_state, "mini_step": 0,
                         "acc": [torch.zeros_like(a) for a in acc]}
        return ([torch.zeros_like(g) for g in grads],
                {"inner": state["inner"], "mini_step": n + 1, "acc": acc})

    return Transform(init, update)


def adabelief(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-16,
              eps_root: float = 1e-16) -> Transform:
    """optax.adabelief: s tracks the squared prediction error g - m, plus
    eps_root, and the step is m_hat / (sqrt(s_hat) + eps)."""

    def update(grads, state, params=None, **extra):
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state["mu"])]
        nu = [(1 - b2) * (g - m) * (g - m) + b2 * v + eps_root
              for g, m, v in zip(grads, mu, state["nu"])]
        count = state["count"] + 1
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        step = -_lr_at(lr, state["count"])
        ups = [step * ((m / c1) / (torch.sqrt(v / c2) + eps))
               for m, v in zip(mu, nu)]
        return ups, {"count": count, "mu": mu, "nu": nu}

    return Transform(_zeros_state, update)


def _trust_ratio(u, p, i: int = 0, spread: Spread | None = None):
    """optax.scale_by_trust_ratio: u * |p| / |u|, or u where either norm
    is 0 (the norms of the whole tensors under a `spread`)."""
    if spread is None:
        pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
    else:
        pn, un = (torch.sqrt(spread.tensor_sum(i, torch.sum(t * t)))
                  for t in (p, u))
    ratio = torch.where((pn == 0.0) | (un == 0.0), torch.ones_like(pn), pn / un)
    return u * ratio


def lamb(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         weight_decay: float = 0.0) -> Transform:
    """optax.lamb: the adam direction (eps 1e-6), plus weight_decay * p,
    scaled per tensor by the trust ratio, then by the learning rate."""
    direction = adam(-1.0, b1=b1, b2=b2, eps=eps)  # rate -1: m_hat / (sqrt(v_hat) + eps)

    def update(grads, state, params, *, spread=None, **extra):
        ups, new = direction.update(grads, state, params)
        ups = [_trust_ratio(u + weight_decay * p, p, i, spread)
               for i, (u, p) in enumerate(zip(ups, params))]
        step = -_lr_at(lr, state["count"])
        return [step * u for u in ups], new

    return Transform(_zeros_state, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    def update(grads, state, params, **extra):
        return [g + weight_decay * p for g, p in zip(grads, params)], state

    return Transform(lambda params: None, update)


def apollo(lr, beta: float = 0.9, eps: float = 1e-4, rebound: float = 0.01,
           warmup: int = 100, init_lr_factor: float = 0.01,
           weight_decay: float = 0.0) -> Transform:
    """The JAX package's apollo: per tensor, the bias-corrected gradient
    EMA m, the diagonal Hessian estimate B moved by the secant correction
    alpha = (d.(m_t - m_{t-1}) - d.B.d) / (|d|_4^4 + eps) along d^2, and
    the direction d = m / max(|B|, rebound); the rate ramps from
    init_lr_factor to 1 over `warmup` steps. weight_decay adds decay * p
    to the gradients first."""

    def init(params):
        return {"count": 0,
                **{k: [torch.zeros_like(p) for p in params]
                   for k in ("exp_avg_grad", "approx_hessian", "update_prev")}}

    def update(grads, state, params=None, *, spread=None, **extra):
        count = state["count"] + 1
        bc = 1.0 - beta ** count
        ms, bs, ds = [], [], []

        def tsum(i, x):
            s = torch.sum(x)
            return s if spread is None else spread.tensor_sum(i, s)

        for i, (g, m, b, d) in enumerate(zip(
                grads, state["exp_avg_grad"], state["approx_hessian"],
                state["update_prev"])):
            delta_m = (g - m) * (1.0 - beta) / bc
            m_new = m + delta_m
            denom4 = tsum(i, d ** 4) + eps
            alpha = (tsum(i, d * delta_m) - tsum(i, d * b * d)) / denom4
            b_new = b - alpha * d * d
            ms.append(m_new)
            bs.append(b_new)
            ds.append(m_new / torch.clamp(torch.abs(b_new), min=rebound))
        ramp = min(count / float(max(warmup, 1)), 1.0)
        lr_t = _lr_at(lr, count) * (init_lr_factor + (1.0 - init_lr_factor) * ramp)
        return ([-lr_t * d for d in ds],
                {"count": count, "exp_avg_grad": ms, "approx_hessian": bs,
                 "update_prev": ds})

    tx = Transform(init, update)
    return chain(add_decayed_weights(weight_decay), tx) if weight_decay else tx


def adahessian(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-4,
               weight_decay: float = 0.0) -> Transform:
    """The JAX package's adahessian: an adam-shaped step whose second
    moment tracks the square of `hessian_diag` (the Hutchinson estimate
    z * Hz that the Learner passes), or of |grad| when none is given;
    weight_decay * p is added to the normalised step."""

    def update(grads, state, params=None, *, hessian_diag=None, **extra):
        count = state["count"] + 1
        hd = hessian_diag if hessian_diag is not None else [g.abs() for g in grads]
        mu = [b1 * m + (1 - b1) * g for m, g in zip(state["mu"], grads)]
        nu = [b2 * v + (1 - b2) * d * d for v, d in zip(state["nu"], hd)]
        mc, vc = 1 - b1 ** count, 1 - b2 ** count
        step = -_lr_at(lr, count)
        ups = []
        for i, (m, v) in enumerate(zip(mu, nu)):
            u = (m / mc) / (torch.sqrt(v / vc) + eps)
            if weight_decay and params is not None:
                u = u + weight_decay * params[i]
            ups.append(step * u)
        return ups, {"count": count, "mu": mu, "nu": nu}

    return Transform(_zeros_state, update)


def plateau_scale(factor: float = 0.1, patience: int = 10, cooldown: int = 0,
                  accumulation_size: int = 1) -> Transform:
    """optax.contrib.reduce_on_plateau with its default tolerances (rtol
    1e-4, atol 0, min_scale 0): the `value` of each call (the loss) is
    averaged over `accumulation_size` calls; a mean below (1 - 1e-4) *
    best is an improvement; `patience` means without one multiply the
    scale by `factor` and start `cooldown` means in which plateaus are
    not counted. Updates are multiplied by the scale. Its numbers are
    0-d float32 and int32 tensors on the parameters' device, so no call
    syncs the host."""

    def init(params):
        dev = params[0].device if params else None

        def f(v, dt=torch.float32):
            return torch.tensor(v, dtype=dt, device=dev)

        return {"best_value": f(float("inf")), "plateau_count": f(0, torch.int32),
                "scale": f(1.0), "cooldown_count": f(0, torch.int32),
                "count": 0, "avg_value": f(0.0)}

    def update_scale(st):
        avg, best = st["avg_value"], st["best_value"]
        improved = avg < (1 - 1e-4) * best
        zero = torch.zeros_like(st["plateau_count"])
        plateau = torch.where(improved, zero, st["plateau_count"] + 1)
        hit = plateau == patience
        cool = st["cooldown_count"] > 0
        scale = torch.where(hit, st["scale"] * factor, st["scale"])
        return {
            "best_value": torch.where(improved, avg, best),
            "plateau_count": torch.where(cool | hit, zero, plateau),
            "scale": torch.where(cool, st["scale"], scale),
            "cooldown_count": torch.where(
                cool, st["cooldown_count"] - 1,
                torch.where(hit, torch.full_like(zero, cooldown), zero)),
            "count": 0,
            "avg_value": torch.zeros_like(avg),
        }

    def update(grads, state, params=None, *, value, **extra):
        n = state["count"] + 1
        value = torch.as_tensor(value).to(state["avg_value"])
        st = dict(state, count=n,
                  avg_value=(state["count"] * state["avg_value"] + value) / n)
        if n == accumulation_size:
            st = update_scale(st)
        return [st["scale"] * g for g in grads], st

    return Transform(init, update)


@torch.no_grad()
def apply_updates(params, updates) -> None:
    for p, u in zip(params, updates):
        p.add_(u.to(p.dtype))


def build_optimizer(name: str, learning_rate, *, weight_decay: float = 0.01,
                    grad_clip: float = 10.0, accumulate: int = 1,
                    reduce_on_plateau: bool = False) -> Transform:
    """clip -> optimizer [-> plateau scaling] [-> MultiSteps], as the JAX
    package chains them. With reduce_on_plateau the caller passes
    `value=loss` to update (the Learner's pass_loss_value); adahessian
    reads the `hessian_diag` the Learner's Hutchinson step passes."""
    name = name.lower()
    if name == "ranger":
        base = lookahead(radam(learning_rate))
    elif name == "ranger_adabelief":
        base = lookahead(adabelief(learning_rate))
    elif name in ("over9000", "lamb"):
        base = lookahead(lamb(learning_rate, weight_decay=weight_decay))
    elif name == "apollo":
        base = apollo(learning_rate, weight_decay=weight_decay)
    elif name == "adahessian":
        base = adahessian(learning_rate, weight_decay=weight_decay)
    elif name == "adam":
        base = adam(learning_rate)
    elif name == "adamw":
        base = adam(learning_rate, weight_decay=weight_decay)
    elif name == "sgd":
        base = sgd(learning_rate, momentum=0.9)
    else:
        raise ValueError(f"unknown optimizer: {name}")
    parts = [clip_by_global_norm(grad_clip), base]
    if reduce_on_plateau:
        parts.append(plateau_scale(factor=0.5, patience=10, cooldown=5,
                                   accumulation_size=50))
    tx = chain(*parts)
    return multi_steps(tx, accumulate) if accumulate > 1 else tx


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear from init_value to
    peak_value over warmup_steps, then a cosine down to end_value at
    decay_steps (counted from 0, the warmup included), constant after.
    Like optax, it raises unless decay_steps > warmup_steps."""
    decay = decay_steps - warmup_steps
    if not decay > 0:
        raise ValueError(f"cosine decay needs decay_steps > warmup_steps, got "
                         f"{decay_steps} and {warmup_steps}")
    alpha = end_value / peak_value if peak_value else 0.0

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, decay)
        return peak_value * ((1 - alpha) * 0.5
                             * (1 + math.cos(math.pi * c / decay)) + alpha)

    return schedule


def make_lr_schedule(conf_training: dict) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule from lr / 25 up to lr over
    warmup_pct of total_steps, then a cosine down to lr / 100."""
    lr = conf_training.get("lr", 5e-4)
    steps = conf_training.get("total_steps", 100_000)
    warmup = max(int(steps * conf_training.get("warmup_pct", 0.3)), 1)
    return warmup_cosine_decay_schedule(lr / 25.0, lr, warmup,
                                        max(steps, warmup + 1), lr / 100.0)
