"""Device choice and the arithmetic helpers the modules share."""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  There is no silent fallback to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device is available; pass device="cpu" to run on '
                'the CPU')
        return torch.device('cuda')
    return torch.device(device)


def div(a: torch.Tensor, c: float) -> torch.Tensor:
    """`a / c` for a Python float `c`, rounded as IEEE division of `a` by
    `c` rounded to `a`'s dtype.  On CUDA, dividing by a Python scalar
    multiplies by its reciprocal (PyTorch's BinaryDivTrueKernel), which is
    a different rounding; a 0-dim tensor on the same device is divided
    truly, as JAX divides by a weakly-typed Python float."""
    return a / torch.full((), c, dtype=a.dtype, device=a.device)


def _round(x: Fraction, np_dtype) -> Fraction:
    """x rounded to the nearest value of np_dtype, ties to even."""
    f = np_dtype(float(x))  # may round twice: settle among the neighbours
    near = [np.nextafter(f, np_dtype(-np.inf)), f,
            np.nextafter(f, np_dtype(np.inf))]
    best = min(near, key=lambda c: (abs(Fraction(float(c)) - x),
                                    int(np.array(c).view(f'u{f.itemsize}'))
                                    % 2))
    return Fraction(float(best))


@functools.lru_cache(maxsize=None)
def linspace(start: float, stop: float, num: int, dtype=torch.float32,
             device=None) -> torch.Tensor:
    """`jnp.linspace(start, stop, num, dtype=dtype)` with the bits of JAX
    on the CPU where start is 0 or -stop with stop a power of two (the
    substrate's [-1, 1] and [-0.5, 0.5], the RBF centres' [0, 10]).  XLA
    compiles `_linspace`'s start * (1 - s) + stop * s, s = i / (num - 1),
    as r = 1 / (num - 1) and c = stop * r rounded to constants, s = i * r,
    and point i < num - 1 as one FMA, i * c + start * (1 - s), every other
    operation rounded; the last point is stop.  (For other starts LLVM may
    fuse the other product, and a last bit can differ.)  `torch.linspace`
    rounds many points differently.  The points are computed exactly on
    the host and rounded once each, once per device: the tensor is cached
    (a graph capture cannot copy from the host), and no caller may write
    to it."""
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]

    def rnd(x):
        return _round(Fraction(x), np_dtype)

    pts = [rnd(start)]
    if num > 1:
        r = rnd(Fraction(1, num - 1))
        a, b = rnd(start), rnd(stop)
        c = rnd(b * r)
        pts = [rnd(rnd(a * rnd(1 - rnd(i * r))) + i * c)
               for i in range(num - 1)] + [b]
    return torch.tensor([float(p) for p in pts[:num]], dtype=dtype,
                        device=device)
