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

`ClipAdam.step` is the PPO minibatch's whole step: the clip, Adam, the
guard and the parameter update.  Its plain version, `step_reference`, is
the sequence `update`, the stop select, `tree_where`, `apply_updates`; the
CPU takes it.  On the card the per-leaf sums of squares and the scalar
bookkeeping stay torch ops and the rest is one launch of
ops/csrc/clip_adam.cu (`step_kernel`), bit for bit equal to the plain
version there: one graph node where the plain version has ~13 per leaf.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, NamedTuple, Optional, Union

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

    def bias_corrections(self, count: torch.Tensor):
        """(count + 1 saturating, 1 - b1^that, 1 - b2^that), the last two
        () float64."""
        count = safe_increment(count)
        c = count.to(torch.float64)
        return count, 1 - torch.pow(self.b1, c), 1 - torch.pow(self.b2, c)

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
        count, bc1, bc2 = self.bias_corrections(state.count)
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

    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             state: AdamState, stop: Optional[torch.Tensor] = None):
        """One step of `params` under the target-KL guard: where the 0-dim
        bool `stop` holds, the params come back as p + 0 and the state as
        it was; `stop` None is no guard.  Returns (params, state).  The
        plain version (`step_reference`) on CPU tensors, one launch of the
        kernel on CUDA tensors (`step_kernel`)."""
        if params[0].is_cuda:
            return step_kernel(self, params, grads, state, stop)
        return self.step_reference(params, grads, state, stop)

    def step_reference(self, params: List[torch.Tensor],
                       grads: List[torch.Tensor], state: AdamState,
                       stop: Optional[torch.Tensor] = None):
        """`step` as the sequence `update`, the stop select, `tree_where`,
        `apply_updates`."""
        updates, new_state = self.update(grads, state)
        if stop is not None:
            updates = [torch.where(stop, torch.zeros_like(u), u)
                       for u in updates]
            new_state = tree_where(stop, state, new_state)
        return apply_updates(params, updates), new_state


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


_DTYPES = {torch.float32: 0, torch.float64: 1}


def _kernel_library():
    """The built `ops/csrc/clip_adam.cu`, with its C signature declared."""
    from gym_copter_tpu_torch.ops import _build

    lib = _build.load('clip_adam')
    fn = lib.gct_clip_adam
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_longlong),
                       ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                       ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(what: str, t: torch.Tensor, dtype, device, shape=None):
    if t.device != device:
        raise ValueError(f'clip_adam: {what} is on {t.device}, not on '
                         f'{device} with the params')
    if t.dtype != dtype:
        raise ValueError(f'clip_adam: {what} must be {dtype}, got {t.dtype}')
    if shape is None:
        if t.numel() != 1:
            raise ValueError(f'clip_adam: {what} must hold one element')
    elif t.shape != shape:
        raise ValueError(f'clip_adam: {what} has shape {tuple(t.shape)}, '
                         f'its param {tuple(shape)}')
    elif not t.is_contiguous():
        raise ValueError(f'clip_adam: {what} must be contiguous')


def step_kernel(opt: ClipAdam, params: List[torch.Tensor],
                grads: List[torch.Tensor], state: AdamState,
                stop: Optional[torch.Tensor] = None):
    """`opt.step` on the card: each leaf's sum of squares (torch's own
    reduction, whose order decides the clip factor's bits), the count and
    its bias corrections and the schedule's rate as torch ops, then one
    launch of ops/csrc/clip_adam.cu on the current stream for the rest,
    into new tensors.  Every tensor must be contiguous, of the params'
    dtype (float32 or float64) and on their card."""
    device, dtype = params[0].device, params[0].dtype
    if not params[0].is_cuda or dtype not in _DTYPES:
        raise ValueError(f'clip_adam: params must be float32 or float64 on '
                         f'the card, got {dtype} on {device}')
    n = len(params)
    if not (len(grads) == len(state.mu) == len(state.nu) == n):
        raise ValueError('clip_adam: params, grads and moments must be as '
                         'many')
    for i, p in enumerate(params):
        for what, t in (('param', p), ('grad', grads[i]),
                        ('mu', state.mu[i]), ('nu', state.nu[i])):
            _check(f'{what} {i}', t, dtype, device, p.shape)
    for what, t in (('count', state.count),
                    ('schedule_count', state.schedule_count)):
        _check(what, t, torch.int32, device)
    if stop is not None:
        _check('stop', stop, torch.bool, device)

    sums = torch.stack([torch.sum(sq)
                        for sq in torch._foreach_mul(grads, grads)])
    count, bc1, bc2 = opt.bias_corrections(state.count)
    rate = None
    if callable(opt.learning_rate):
        rate = opt.learning_rate(state.schedule_count).to(dtype)
        _check('the rate', rate, dtype, device)
    outs = [[torch.empty_like(t) for t in ts]
            for ts in (params, state.mu, state.nu)]
    new_count = torch.empty_like(state.count)
    new_schedule_count = torch.empty_like(state.schedule_count)

    leaves = (params, grads, state.mu, state.nu) + tuple(outs)
    ptrs = (ctypes.c_void_p * (7 * n))(
        *(ts[i].data_ptr() for i in range(n) for ts in leaves))
    numel = (ctypes.c_longlong * n)(*(p.numel() for p in params))
    scalars = (sums, bc1, bc2, rate, state.count, count, new_count,
               state.schedule_count, new_schedule_count, stop)
    sp = (ctypes.c_void_p * len(scalars))(
        *(None if t is None else t.data_ptr() for t in scalars))
    consts = (ctypes.c_double * 7)(
        opt.max_grad_norm, opt.b1, 1 - opt.b1, opt.b2, 1 - opt.b2, opt.eps,
        0.0 if rate is not None else -opt.learning_rate)
    lib = _kernel_library()
    with torch.cuda.device(device):
        err = lib.gct_clip_adam(_DTYPES[dtype], n, ptrs, numel, sp,
                                len(scalars), consts, len(consts),
                                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        from gym_copter_tpu_torch.ops import _build
        raise RuntimeError(f'clip_adam kernel launch failed: '
                           f'{_build.error_string(lib, err)}')
    step_kernel.launches += 1
    new_params, mu, nu = outs
    return new_params, AdamState(count=new_count, mu=mu, nu=nu,
                                 schedule_count=new_schedule_count)


step_kernel.launches = 0
