"""Brute-force feature matching as one dense distance matrix.

Port of `vslam_tpu.features.matcher` (reference MatcherBruteForce,
Matcher.cpp:37-58): per query, the best candidate must beat the maximum
distance and Lowe's ratio against the second best. The distance matrix is
the binary descriptors' L1 (one matmul: |a| + |b| - 2 a.b), the
reprojection error of each candidate's 3-D point (Matcher.cpp:73-90), or
their sum (the custom matcher of NodeMapping.cpp:103-113); the epipolar
distance (Matcher.cpp:59-72) comes from the fundamental matrix
(algorithm.cpp computeF). Every function takes leading batch axes.

Ties break as in the JAX package: `argmin` takes the first index, and with
``unique`` the lowest query index wins a contested candidate.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = [
    "MatchResult",
    "descriptor_l1_matrix",
    "reprojection_error_matrix",
    "epipolar_error_matrix",
    "ratio_match",
    "fundamental_matrix",
]


class MatchResult(NamedTuple):
    idx: torch.Tensor  # (..., N) best candidate per query
    distance: torch.Tensor  # (..., N)
    valid: torch.Tensor  # (..., N) passed the max-distance and ratio tests


def descriptor_l1_matrix(desc_q: torch.Tensor, desc_c: torch.Tensor) -> torch.Tensor:
    """(..., N, M) L1 distances between binary descriptors (..., N, 256) and
    (..., M, 256), one matmul."""
    na = desc_q.sum(dim=-1, keepdim=True)
    nb = desc_c.sum(dim=-1, keepdim=True).transpose(-1, -2)
    return na + nb - 2.0 * (desc_q @ desc_c.transpose(-1, -2))


def reprojection_error_matrix(p3d_c: torch.Tensor, uv_q: torch.Tensor, fx, fy, cx, cy,
                              invalid_value: float = 0.0) -> torch.Tensor:
    """(..., N, M) pixel distances from query keypoints uv_q (..., N, 2) to
    candidates p3d_c (..., M, 3) projected in the query camera; candidates
    behind it get ``invalid_value`` (NodeMapping.cpp:105-110)."""
    z = p3d_c[..., 2]
    ok = z > 1e-6
    zs = torch.where(ok, z, torch.ones_like(z))
    u = fx * p3d_c[..., 0] / zs + cx
    v = fy * p3d_c[..., 1] / zs + cy
    du = uv_q[..., 0:1] - u[..., None, :]
    dv = uv_q[..., 1:2] - v[..., None, :]
    r = torch.sqrt(du * du + dv * dv)
    return torch.where(ok[..., None, :], r, torch.full_like(r, invalid_value))


def epipolar_error_matrix(F: torch.Tensor, uv_q: torch.Tensor, uv_c: torch.Tensor) -> torch.Tensor:
    """(N, M) point-to-epipolar-line distances |x_q^T l| / ||l_xy|| for F
    (3, 3) candidate -> query (Matcher.cpp:59-72)."""
    xc = torch.cat([uv_c, torch.ones_like(uv_c[:, :1])], dim=1)
    line = xc @ F.T
    norm = torch.sqrt(line[:, 0] ** 2 + line[:, 1] ** 2)
    line = line / torch.clamp(norm, min=1e-12)[:, None]
    xq = torch.cat([uv_q, torch.ones_like(uv_q[:, :1])], dim=1)
    return torch.abs(xq @ line.T)


def ratio_match(dist: torch.Tensor, mask_q: Optional[torch.Tensor] = None,
                mask_c: Optional[torch.Tensor] = None, max_distance: float = 1000.0,
                min_distance_ratio: float = 0.8, unique: bool = False) -> MatchResult:
    """Best and second best per row of dist (..., N, M); accept if best <
    max_distance and best < ratio * second (Matcher.cpp:48-56). ``unique``
    makes the assignment one-to-one: of the queries matching one candidate,
    only the lowest distance (then the lowest query index) keeps it."""
    big = torch.tensor(torch.finfo(dist.dtype).max, dtype=dist.dtype, device=dist.device)
    if mask_c is not None:
        dist = torch.where(mask_c[..., None, :], dist, big)
    idx = torch.argmin(dist, dim=-1)
    best = torch.take_along_dim(dist, idx[..., None], dim=-1)[..., 0]
    M = dist.shape[-1]
    hit = torch.arange(M, device=dist.device) == idx[..., None]
    second = torch.where(hit, big, dist).amin(dim=-1)
    valid = (best < max_distance) & (best < min_distance_ratio * second)
    if mask_q is not None:
        valid = valid & mask_q
    if unique:
        N = dist.shape[-2]
        key = torch.where(valid, best, big)
        best_per_c = torch.full((*dist.shape[:-2], M), torch.finfo(dist.dtype).max, dtype=dist.dtype,
                                device=dist.device).scatter_reduce(-1, idx, key, "amin", include_self=True)
        is_best = valid & (key <= torch.take_along_dim(best_per_c, idx, dim=-1))
        qi = torch.arange(N, device=dist.device).expand_as(idx)
        winner_q = torch.full((*dist.shape[:-2], M), N, dtype=qi.dtype, device=dist.device).scatter_reduce(
            -1, idx, torch.where(is_best, qi, torch.full_like(qi, N)), "amin", include_self=True)
        valid = is_best & (torch.take_along_dim(winner_q, idx, dim=-1) == qi)
    return MatchResult(idx=idx, distance=best, valid=valid)


def fundamental_matrix(K_ref: torch.Tensor, rel, K_cur: torch.Tensor) -> torch.Tensor:
    """F = K_cur^-T [t]x R K_ref^-1 from the relative transform cur <- ref
    (a 4x4, or an SE3 with R and t) and 3x3 intrinsics (algorithm.cpp computeF)."""
    if hasattr(rel, "R"):
        R, t = rel.R, rel.t
    else:
        R, t = rel[:3, :3], rel[:3, 3]
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    tx = torch.stack([torch.stack([zero, -t[2], t[1]]), torch.stack([t[2], zero, -t[0]]),
                      torch.stack([-t[1], t[0], zero])])
    E = tx @ R
    return torch.linalg.inv(K_cur).T @ E @ torch.linalg.inv(K_ref)
