"""The part of `jax.random` that the env and the PPO learner use, on torch
tensors.

The JAX package draws each env's reset wind kick as
`uniform(fold_in(fold_in(PRNGKey(seed), env_id), episode), (3,), -F, F)`
(envs/base.py `_initial_forces`), and its PPO learner splits keys, draws
Gaussian exploration noise and permutes minibatch blocks (learn/ppo.py).
This module reproduces those bits: threefry2x32 with JAX's key schedule and
rotations, `fold_in`, `split`, `random_bits`, `uniform`, `normal` and
`permutation` in the partitionable counter layout
(`jax_threefry_partitionable`, the default), for float32 (32 random bits)
and float64 (64 random bits, as JAX draws them with x64 on).  Every draw is
bit-equal to JAX's except `normal`, whose `torch.erfinv` differs from XLA's
polynomial by 1 ULP at the median and by up to some hundreds of ULP in the
far tails.

torch has no uint32 arithmetic, and its int32 `>>` is arithmetic, so the
words are held in int64 tensors and every sum is masked with 0xFFFFFFFF.
Right shifts of a masked word are then logical.  A key is an int64 tensor
of shape (..., 2); all functions broadcast over the leading dimensions.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gym_copter_tpu_torch.core.device import resolve_device

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x, d):
    return ((x << d) & _M32) | (x >> (32 - d))


def threefry2x32(k1, k2, c1, c2):
    """Threefry-2x32 with 20 rounds, as `jax._src.prng` computes it; every
    argument is an int64 tensor (or int) holding uint32 words.  Returns the
    two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (c1 + ks[0]) & _M32
    x1 = (c2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` with x64 on: the 64-bit seed split into
    its high and low words."""
    s = int(seed) % (1 << 64)
    return torch.tensor([s >> 32, s & _M32], dtype=torch.int64,
                        device=resolve_device(device))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in`: threefry of the counter pair (0, uint32(data))
    under `key`.  `data` is an int or an integer tensor; the result has the
    broadcast shape of key[..., 0] and data, plus the trailing 2."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _M32
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([o0, o1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)` for one key (2,): key i is the threefry
    of the counter pair (0, i), so `split(key, n)[i] == fold_in(key, i)`.
    Returns (num, 2)."""
    counts = torch.arange(num, dtype=torch.int64, device=key.device)
    o0, o1 = threefry2x32(key[0], key[1], torch.zeros_like(counts), counts)
    return torch.stack([o0, o1], dim=-1)


def _words(key: torch.Tensor, shape) -> tuple:
    """The two threefry words of the counters 0 .. prod(shape) - 1 under one
    key (2,), each of `shape`."""
    counts = torch.arange(math.prod(shape), dtype=torch.int64,
                          device=key.device).reshape(shape)
    return threefry2x32(key[0], key[1], torch.zeros_like(counts), counts)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.bits(key, shape, uint32)`: int64 values in [0, 2**32)."""
    b1, b2 = _words(key, shape)
    return b1 ^ b2


def _unit_floats(b1, b2, dtype):
    """Floats in [1, 2) from the two threefry words, as `jax.random.uniform`
    makes them: the mantissa is the top bits of the 32-bit draw b1 ^ b2
    (float32) or of the 64-bit draw (b1 << 32) | b2 (float64)."""
    if dtype == torch.float32:
        bits = ((b1 ^ b2) >> 9) | 0x3F800000
        return bits.to(torch.int32).view(torch.float32)
    if dtype == torch.float64:
        bits = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
        return bits.view(torch.float64)
    raise TypeError(f'draws support float32 and float64, not {dtype}')


def uniform(key: torch.Tensor, n: int, minval: float, maxval: float,
            dtype=torch.float32) -> torch.Tensor:
    """`jax.random.uniform(key, (n,), dtype, minval, maxval)` for symmetric
    bounds (minval == -maxval, the only form the env draws).  Returns shape
    key.shape[:-1] + (n,).

    JAX computes `f * (maxval - minval) + minval` for f in [0, 1), and
    XLA on the CPU fuses that into one FMA, a single rounding.  For
    symmetric bounds the exact value is maxval * (2f - 1), and 2f - 1 is
    exact (f is a multiple of 2**-mantissa_bits), so one rounded multiply
    gives the same bits without an FMA."""
    if minval != -maxval:
        raise ValueError(
            f'uniform draws symmetric bounds only, got [{minval}, {maxval})')
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0:1], key[..., 1:2],
                          torch.zeros_like(counts), counts)
    floats = _unit_floats(b1, b2, dtype)
    hi = torch.full((), maxval, dtype=dtype, device=key.device)
    # floats - 1 is f; f * 2 - 1 is exact, so only the multiply rounds
    return torch.maximum(-hi, hi * ((floats - 1.0) * 2.0 - 1.0))


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def normal(key: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """`jax.random.normal(key, shape, dtype)` for one key (2,):
    sqrt(2) * erfinv(u), u uniform on [nextafter(-1, 0), 1).

    JAX computes u = f * (1 - lo) + lo; 1 - lo rounds to 2.0, so u is
    2f + lo with 2f exact: one rounding with an FMA or without, and u is
    bit-equal.  `torch.erfinv` and XLA's erf_inv polynomial differ by 1 ULP
    at the median, more in the far tails (tests/test_torch_prng.py states
    the measured gap)."""
    np_dtype = _NP_DTYPES[dtype]
    lo = float(np.nextafter(np_dtype(-1.0), np_dtype(0.0)))
    b1, b2 = _words(key, shape)
    u = (_unit_floats(b1, b2, dtype) - 1.0) * 2.0 + lo
    u = torch.maximum(u, torch.full((), lo, dtype=dtype, device=key.device))
    return torch.erfinv(u) * math.sqrt(2.0)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.permutation(key, n)` for an int n (`jax._src.random.
    _shuffle`): ceil(3 ln n / ln(2**32 - 1)) rounds, each a split, 32 random
    bits per element and a stable sort of the elements by those bits (2
    rounds for n in (1625, 2**21]).  JAX's `sort_key_val` is stable too, so
    the two agree on ties (equal keys keep their order) as everywhere else.
    Returns an int64 tensor (n,)."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x
