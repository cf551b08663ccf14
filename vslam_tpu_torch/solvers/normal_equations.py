"""Weighted normal equations (port of `vslam_tpu.solvers.normal_equations`):
A = J^T W J, b = J^T W r, chi2 = r^T W r and the constraint count n, each
with the caller's leading batch axes."""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["NormalEquations"]


class NormalEquations(NamedTuple):
    A: torch.Tensor  # (..., N, N)
    b: torch.Tensor  # (..., N)
    chi2: torch.Tensor  # (...,)
    n: torch.Tensor  # (...,) number of constraints (float)
