"""The PPO learner's optimizer: optax's `chain(clip_by_global_norm(c),
adam(lr))` written out on lists of tensors.

The JAX package trains with that chain (learn/ppo.py `make_train_step` and
`train`).  This module repeats optax's formulas term for term, so that in
float64 the two agree to rounding:

  * clipping: `select(g_norm < max_norm, g, g / g_norm * max_norm)` with
    g_norm the square root of the sum of every leaf's squares;
  * Adam: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, the count
    incremented first (saturating, as `optax.safe_increment`), the moments
    divided by 1 - b^count, and mu_hat / (sqrt(nu_hat) + eps);
  * the learning rate: updates scaled by -lr, where a schedule reads its own
    count before incrementing it (`optax.scale_by_schedule`);
  * `linear_schedule` as `optax.linear_schedule` evaluates inside the JAX
    package's jitted train step, not as it evaluates eagerly: XLA's CPU
    compile turns `count / T` into `count * f32(1/T)` and contracts the rest
    into two float32 fused multiply-adds, which differ from the eager
    formula by one float32 ULP at many counts (and so move a float64 step
    by ~1e-10).

There is no `torch.optim` here: the PPO update's `target_kl` guard keeps the
old moments and counts where it stops, which takes a `torch.where` over the
whole optimizer state, and every step runs inside a CUDA graph, so the state
is plain tensors and no step reads a value back to the host.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Union

import numpy as np
import torch

_INT32_MAX = 2 ** 31 - 1


class AdamState(NamedTuple):
    """Adam's count and moments (optax `ScaleByAdamState`) and the learning
    rate schedule's own count (`ScaleByScheduleState`; it stays 0 under a
    constant rate, which has no state in optax).  Counts are () int32."""

    count: torch.Tensor
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    schedule_count: torch.Tensor


def safe_increment(count: torch.Tensor) -> torch.Tensor:
    """count + 1, saturating at the int32 maximum (`optax.safe_increment`)."""
    return torch.where(count < _INT32_MAX, count + 1, count)


def fma32(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """The float32 fused multiply-add a * b + c, rounded once, for a float64
    tensor `a` and floats b, c that all hold float32 values.

    The float64 product is exact (24 + 24 bits).  The float64 sum is made
    round-to-odd: where TwoSum says it was inexact and its last bit is even,
    it steps one float64 ULP toward the exact sum.  Rounding that to float32
    (24 bits, two or more fewer than float64's 53) is then the correctly
    rounded sum, with no double rounding.  Plain elementwise ops, so the
    CPU and the card give the same bits and a CUDA graph captures it."""
    p = a * b
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    # toward the exact sum where it is inexact, s itself where it is exact:
    # a nonzero err is a multiple of 2^-298 (two float32 ULPs multiplied),
    # so err * 2^1000 lies far beyond s or overflows, on err's side
    away = torch.nextafter(s, s + err * 2.0 ** 1000)
    return torch.where((s.view(torch.int64) & 1) == 0, away,
                       s).to(torch.float32)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable:
    """`optax.linear_schedule` (count -> init + (end - init) * min(count,
    steps) / steps, a float32 tensor; 0 < steps < 2^24) rounded as the JAX
    package's jitted train step rounds it.

    XLA's CPU compile of the schedule computes
    `fma(fma(-c, f32(1/steps), 1), f32(init - end), f32(end))` in float32,
    with c the clamped count and `init - end` the Python difference rounded
    once (a weak-typed constant).  The first sum is exact in float64 (c is
    an integer below 2^24 and f32(1/steps) >= 2^-24, so every bit of
    c * f32(1/steps) lies at 2^-47 or above), so one rounding to float32
    is the FMA's; the second is too when end is 0, and takes `fma32`
    otherwise."""
    if not 0 < transition_steps < 2 ** 24:
        raise ValueError(f'transition_steps {transition_steps} outside '
                         f'(0, 2^24)')
    r = float(np.float32(1.0 / transition_steps))
    d = float(np.float32(init_value - end_value))
    e = float(np.float32(end_value))

    def schedule(count):
        c = torch.clamp(count, 0, transition_steps).to(torch.float64)
        frac = (c * -r + 1).to(torch.float32).to(torch.float64)
        return fma32(frac, d, e) if e else (frac * d).to(torch.float32)

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The square root of the sum of every tensor's squares."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class ClipAdam(NamedTuple):
    """`optax.chain(optax.clip_by_global_norm(max_grad_norm),
    optax.adam(learning_rate))`; learning_rate is a float or a schedule
    (count -> rate)."""

    max_grad_norm: float
    learning_rate: Union[float, Callable]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: List[torch.Tensor]) -> AdamState:
        zero = torch.zeros((), dtype=torch.int32, device=params[0].device)
        return AdamState(count=zero,
                         mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params],
                         schedule_count=zero.clone())

    def update(self, grads: List[torch.Tensor], state: AdamState):
        """Returns (updates, new state), as optax's `update` does."""
        g_norm = global_norm(grads)
        # select(trigger, g, g / n * m) as one expression: with n = m = 1
        # where the norm is under the limit, g / 1 * 1 is g exactly
        trigger = g_norm < self.max_grad_norm
        n = torch.where(trigger, torch.ones_like(g_norm), g_norm)
        m = torch.where(trigger, torch.ones_like(g_norm),
                        torch.full_like(g_norm, self.max_grad_norm))
        grads = [g / n.to(g.dtype) * m.to(g.dtype) for g in grads]

        b1, b2 = self.b1, self.b2
        mu = [(1 - b1) * g + b1 * t for g, t in zip(grads, state.mu)]
        nu = [(1 - b2) * (g * g) + b2 * t for g, t in zip(grads, state.nu)]
        count = safe_increment(state.count)
        c = count.to(torch.float64)
        bc1 = 1 - torch.pow(b1, c)
        bc2 = 1 - torch.pow(b2, c)
        updates = [(m_ / bc1.to(m_.dtype)) / (torch.sqrt(v / bc2.to(v.dtype))
                                              + self.eps)
                   for m_, v in zip(mu, nu)]

        if callable(self.learning_rate):
            step_size = -1 * self.learning_rate(state.schedule_count)
            updates = [step_size.to(u.dtype) * u for u in updates]
            schedule_count = safe_increment(state.schedule_count)
        else:
            updates = [-self.learning_rate * u for u in updates]
            schedule_count = state.schedule_count
        return updates, AdamState(count=count, mu=mu, nu=nu,
                                  schedule_count=schedule_count)


def apply_updates(params: List[torch.Tensor],
                  updates: List[torch.Tensor]) -> List[torch.Tensor]:
    """`optax.apply_updates`: p + u in p's dtype."""
    return [(p + u).to(p.dtype) for p, u in zip(params, updates)]


def tree_where(cond: torch.Tensor, a: AdamState, b: AdamState) -> AdamState:
    """The state `a` where the 0-dim bool `cond` holds, else `b`."""
    def w(x, y):
        return torch.where(cond, x, y)

    return AdamState(count=w(a.count, b.count),
                     mu=[w(x, y) for x, y in zip(a.mu, b.mu)],
                     nu=[w(x, y) for x, y in zip(a.nu, b.nu)],
                     schedule_count=w(a.schedule_count, b.schedule_count))
