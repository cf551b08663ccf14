"""Weighted normal equations (port of `vslam_tpu.solvers.normal_equations`):
A = J^T W J, b = J^T W r, chi2 = r^T W r and the constraint count n, each
with the caller's leading batch axes (reference `least_squares/src/
NormalEquations.{h,cpp}`)."""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..utils.tree import tree_map

__all__ = ["NormalEquations", "build", "combine", "scale"]


class NormalEquations(NamedTuple):
    A: torch.Tensor  # (..., N, N)
    b: torch.Tensor  # (..., N)
    chi2: torch.Tensor  # (...,)
    n: torch.Tensor  # (...,) number of constraints (float)


def build(J: torch.Tensor, r: torch.Tensor, w: torch.Tensor, n: torch.Tensor | None = None) -> NormalEquations:
    """From stacked Jacobian rows ``J: (..., P, N)``, residuals ``r: (..., P)``
    and weights ``w: (..., P)``; zero-weight rows contribute nothing. ``n``
    overrides the constraint count, which defaults to P (the reference
    counts every interest point, `NormalEquations.cpp:52-60`)."""
    Jw = J * w[..., None]
    A = Jw.transpose(-1, -2) @ J
    b = (Jw.transpose(-1, -2) @ r[..., None])[..., 0]
    chi2 = torch.sum(w * r * r, dim=-1)
    if n is None:
        n = torch.full(r.shape[:-1], float(J.shape[-2]), dtype=r.dtype, device=r.device)
    return NormalEquations(A, b, chi2, n)


def combine(nes: Sequence[NormalEquations]) -> NormalEquations:
    """Sum of normal equations (reference NormalEquations::combine)."""
    return tree_map(lambda *xs: sum(xs), *nes)


def scale(ne: NormalEquations, s) -> NormalEquations:
    return NormalEquations(ne.A * s, ne.b * s, ne.chi2 * s, ne.n)
