"""Threefry-2x32 draws on torch tensors: the counter-based generator that
the benchmark's reference train step and env reset draw from.

A frozen copy of the draws the measured package makes (the partitionable
counter layout of `jax.random`: `fold_in`, `split`, `uniform`, `normal`,
`permutation`), kept here so that the reference shares no code with the
program it checks.  Words are held in int64 tensors and every sum is masked
with 0xFFFFFFFF.  On the CPU the rounds run in numpy's uint32 and square
roots in numpy, whose results are the IEEE ones; on the card in torch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x, d):
    return ((x << d) & _M32) | (x >> (32 - d))


def threefry2x32(k1, k2, c1, c2):
    """Threefry-2x32 with 20 rounds, as `jax._src.prng` computes it; every
    argument is an int64 tensor (or int) holding uint32 words.  Returns the
    two output words.

    On the CPU the rounds run in numpy's uint32, whose sums wrap without
    masks: some 60 operations on small arrays instead of ~130 torch
    launches, 5x faster at the env's per-step reset draw."""
    if not any(isinstance(x, torch.Tensor) and x.is_cuda
               for x in (k1, k2, c1, c2)):
        return _threefry2x32_numpy(k1, k2, c1, c2)
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


def _threefry2x32_numpy(k1, k2, c1, c2):
    """`threefry2x32` of CPU tensors or ints in numpy uint32 arithmetic;
    returns int64 tensors."""
    def word(x):
        x = x.numpy() if isinstance(x, torch.Tensor) else x
        return np.asarray(x).astype(np.uint32)

    k1, k2, c1, c2 = (word(x) for x in (k1, k2, c1, c2))
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(_KS_PARITY))
    with np.errstate(over='ignore'):
        x0, x1 = c1 + ks[0], c2 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return tuple(torch.from_numpy(np.asarray(x).astype(np.int64))
                 for x in (x0, x1))


def PRNGKey(seed: int, device) -> torch.Tensor:
    """A threefry key from a 64-bit seed: its high and low words."""
    s = int(seed) % (1 << 64)
    return torch.tensor([s >> 32, s & _M32], dtype=torch.int64,
                        device=device)


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


def _words(key: torch.Tensor, shape, cols=None) -> tuple:
    """The two threefry words under one key (2,) of the counters 0 ..
    prod(shape) - 1 laid out in `shape`, or of their trailing-axis columns
    cols = (lo, hi) only; each word has shape shape[:-1] + (hi - lo,)."""
    *lead, width = shape
    lo, hi = (0, width) if cols is None else cols
    if not 0 <= lo <= hi <= width:
        raise ValueError(f'columns {cols} outside a trailing axis of {width}')
    rows = torch.arange(math.prod(lead), dtype=torch.int64,
                        device=key.device)[:, None] * width
    counts = (rows + torch.arange(lo, hi, dtype=torch.int64,
                                  device=key.device)).reshape(*lead, hi - lo)
    return threefry2x32(key[0], key[1], torch.zeros_like(counts), counts)


def random_bits(key: torch.Tensor, shape, cols=None) -> torch.Tensor:
    """`jax.random.bits(key, shape, uint32)`: int64 values in [0, 2**32);
    with cols = (lo, hi), only those columns of the trailing axis."""
    b1, b2 = _words(key, shape, cols)
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


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """`jax.random.uniform(key, shape, dtype, minval, maxval)` for bounds
    [0, maxval) or symmetric ones [-maxval, maxval) (the env's reset draw).
    `shape` is an int or a tuple; each key of key's leading dimensions
    draws the whole shape, so the result has shape key.shape[:-1] + shape.

    JAX computes `f * (maxval - minval) + minval` for f in [0, 1), and
    XLA on the CPU fuses that into one FMA, a single rounding.  For minval
    0 that is the one rounded product f * maxval.  For symmetric bounds the
    exact value is maxval * (2f - 1), and 2f - 1 is exact (f is a multiple
    of 2**-mantissa_bits), so one rounded multiply gives the same bits
    without an FMA."""
    if minval != 0.0 and minval != -maxval:
        raise ValueError(f'uniform draws [0, m) or symmetric bounds only, '
                         f'got [{minval}, {maxval})')
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    counts = torch.arange(math.prod(shape), dtype=torch.int64,
                          device=key.device).reshape(shape)
    lead = key.shape[:-1] + (1,) * len(shape)
    b1, b2 = threefry2x32(key[..., 0].reshape(lead),
                          key[..., 1].reshape(lead),
                          torch.zeros_like(counts), counts)
    f = _unit_floats(b1, b2, dtype) - 1.0
    hi = torch.full((), maxval, dtype=dtype, device=key.device)
    if minval == -maxval:
        # f * 2 - 1 is exact, so only the multiply rounds
        return torch.maximum(-hi, hi * (f * 2.0 - 1.0))
    return torch.clamp_min(f * hi, 0.0)


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}

# XLA's erf_inv (`ErfInv32`/`ErfInv64`, as `chlo.erf_inv` lowers on the CPU
# and GPU): Giles' polynomials in w = -log1p(-x^2), highest order first, each
# with the shift of w it is evaluated at: (w below which it applies, use
# sqrt(w), shift, coefficients)
_ERF_INV_POLYS = {
    torch.float32: (
        (5.0, False, 2.5, (
            2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
            0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
            1.50140941)),
        (math.inf, True, 3.0, (
            -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
            0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
            2.83297682))),
}


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The IEEE square root.  On the CPU `torch.sqrt` (like `torch.erfinv`,
    `exp`, `sin`) calls MKL's vector library, which rounds 0.7 % of float32
    square roots differently and, on its first call from several threads of
    a process that shares the CPU with others, can compute one thread's
    share with a variant accurate to only 6e-5; numpy's is exact."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.from_numpy(np.sqrt(x.numpy()))


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's erf_inv for x in (-1, 1): each polynomial is evaluated on every
    element by Horner's rule, `c + p * w` as XLA writes it, and each element
    takes the one its w selects, so it gets XLA's operations in XLA's order.
    What differs is torch's `log1p`, and XLA's fusing `c + p * w` into one
    FMA (tests/test_torch_prng.py states the measured gap)."""
    w = -torch.log1p(-(x * x))
    sqrt_w = _sqrt(w)
    out = None
    for below, use_sqrt, shift, coeffs in reversed(_ERF_INV_POLYS[x.dtype]):
        t = (sqrt_w if use_sqrt else w) - shift
        p = torch.full_like(x, coeffs[0])
        for c in coeffs[1:]:
            p = c + p * t
        out = p if out is None else torch.where(w < below, p, out)
    return out * x


def normal(key: torch.Tensor, shape, dtype=torch.float32,
           cols=None) -> torch.Tensor:
    """`jax.random.normal(key, shape, dtype)` for one key (2,):
    sqrt(2) * erf_inv(u), u uniform on [nextafter(-1, 0), 1); with cols =
    (lo, hi), only those columns of the trailing axis.

    JAX computes u = f * (1 - lo) + lo; 1 - lo rounds to 2.0, so u is
    2f + lo with 2f exact: one rounding with an FMA or without, and u is
    bit-equal.  erf_inv is XLA's polynomial (`_erf_inv`), not
    `torch.erfinv`, whose rational guess and Newton steps on libm's `erff`
    and `expf` differ from XLA's by up to 91 ULP in float32 (682 in
    float64)."""
    np_dtype = _NP_DTYPES[dtype]
    lo = float(np.nextafter(np_dtype(-1.0), np_dtype(0.0)))
    b1, b2 = _words(key, shape, cols)
    u = (_unit_floats(b1, b2, dtype) - 1.0) * 2.0 + lo
    u = torch.maximum(u, torch.full((), lo, dtype=dtype, device=key.device))
    return _erf_inv(u) * math.sqrt(2.0)


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
