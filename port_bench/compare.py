"""The numbers that decide `correct`: each a gap between what the timed
path produced and what the plain reference (port_bench/reference) works
out from the same inputs, and 0 where the two agree bit for bit."""

from __future__ import annotations

import statistics

import torch


def rel(a: float, b: float) -> float:
    """|a - b| / |b|; 0 where both are 0, inf where only b is."""
    if a == b:
        return 0.0
    return abs(a - b) / abs(b) if b != 0 else float('inf')


def leaf_norm_gap(program, reference, skip=()) -> float:
    """The worst leaf's gap between the program's norm and the reference's
    (not the norm of their difference), over the larger of that leaf's
    reference norm and the median leaf's; leaves whose index is in `skip`
    are left out."""
    p = [float(torch.linalg.vector_norm(x.double())) for x in program]
    r = [float(torch.linalg.vector_norm(x.double())) for x in reference]
    median = statistics.median(r)
    gaps = [abs(a - b) / max(b, median) if max(b, median) > 0 else
            (0.0 if a == b else float('inf'))
            for i, (a, b) in enumerate(zip(p, r)) if i not in skip]
    return max(gaps)


def still_leaves(grad_norms, share: float = 1e-3) -> set:
    """Indices of the leaves whose reference gradient norm is under `share`
    of the median leaf's: nought to rounding, so that Adam moves them by
    round-off alone."""
    median = statistics.median(grad_norms)
    return {i for i, g in enumerate(grad_norms) if g < share * median}


def max_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """max |p - r| / max(|r|, 1) elementwise (in float64), over tensors of
    one shape; inf where the program holds a NaN the reference does not."""
    p, r = program.double().cpu(), reference.double().cpu()
    if p.shape != r.shape:
        raise ValueError(f'shapes {tuple(p.shape)} and {tuple(r.shape)}')
    if p.numel() == 0:
        return 0.0
    same_nan = torch.isnan(p) & torch.isnan(r)
    gap = torch.where(same_nan, torch.zeros_like(p),
                      (p - r).abs() / r.abs().clamp_min(1.0))
    gap = torch.where(torch.isnan(gap), torch.full_like(gap, float('inf')),
                      gap)
    return float(gap.max())
