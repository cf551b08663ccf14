"""Unrolled small-matrix linear algebra (port of `vslam_tpu.solvers.linalg6`).

A = J^T W J (+ prior) is symmetric positive semi-definite, so Cholesky is
the factorization; its pivots give the log-determinant for the reference's
conditioning guard (GaussNewton.cpp:59-63). Unrolled over the 6x6 entries
and batched over leading axes, so the CUDA kernel's scalar tail
(`csrc/fused_solve.cu`) and this code run the same arithmetic.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["cholesky_solve", "cholesky_det_solve", "cholesky_logdet_solve", "inv_psd", "inv3"]


def _chol_factor(A: torch.Tensor):
    """Unrolled Cholesky of (..., N, N) -> (L as nested lists, bad).

    ``bad`` marks a non-finite scale or a pivot <= 1e-10 x the largest
    diagonal entry (relative degeneracy: a rank-deficient A with large
    healthy pivots would otherwise pass the absolute det guard)."""
    N = A.shape[-1]
    L = [[None] * N for _ in range(N)]
    scale = A[..., 0, 0]
    for j in range(1, N):
        scale = torch.maximum(scale, A[..., j, j])
    bad = ~torch.isfinite(scale)
    for j in range(N):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        bad = bad | (s <= 1e-10 * scale)
        L[j][j] = torch.sqrt(torch.clamp(s, min=1e-30))
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, N):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    return L, bad


def _substitute(L, b: torch.Tensor) -> torch.Tensor:
    """Solve L L^T x = b given the nested-list factor."""
    N = len(L)
    y = [None] * N
    for i in range(N):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * N
    for i in reversed(range(N)):
        s = y[i]
        for k in range(i + 1, N):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def cholesky_det_solve(A: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve A x = b for SPD A; return (x, det A), 0 for a degenerate factor.
    det = prod(diag L)^2 overflows f32 for large Jacobians, where the
    guards use `cholesky_logdet_solve`."""
    L, bad = _chol_factor(A)
    det_sqrt = L[0][0]
    for j in range(1, len(L)):
        det_sqrt = det_sqrt * L[j][j]
    det = torch.where(bad, torch.zeros_like(det_sqrt), det_sqrt * det_sqrt)
    return _substitute(L, b), det


def cholesky_logdet_solve(A: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve A x = b; return (x, log|det A|), -inf for a degenerate factor.
    The log domain never overflows f32 for close-range depth."""
    L, bad = _chol_factor(A)
    logdet = torch.log(L[0][0])
    for j in range(1, len(L)):
        logdet = logdet + torch.log(L[j][j])
    logdet = torch.where(bad, torch.full_like(logdet, -float("inf")), 2.0 * logdet)
    return _substitute(L, b), logdet


def cholesky_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    L, _ = _chol_factor(A)
    return _substitute(L, b)


def inv_psd(A: torch.Tensor) -> torch.Tensor:
    """Inverse of an SPD matrix via N unrolled solves (columns of I), all N
    right-hand sides at once along an extra axis."""
    N = A.shape[-1]
    L, _ = _chol_factor(A)
    L = [[None if x is None else x[..., None] for x in row] for row in L]
    eye = torch.eye(N, dtype=A.dtype, device=A.device).expand(*A.shape[:-2], N, N)
    return _substitute(L, eye).transpose(-1, -2)  # row i solved for e_i -> column i


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of (..., 3, 3): the bundle
    adjustment's point blocks, batched."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det, torch.full_like(det, 1e-30))
    rows = [torch.stack([A11, A12, A13], dim=-1), torch.stack([A21, A22, A23], dim=-1),
            torch.stack([A31, A32, A33], dim=-1)]
    return torch.stack(rows, dim=-2) * inv_det[..., None, None]
