"""Dense FAST corner detection with one keypoint per grid cell.

Port of `vslam_tpu.features.detector` (FeatureTracking.cpp:81-136:
FAST-9/16 at threshold 10, masked by valid depth above 0.1 m, then the best
response in each 30-px grid cell). Every function takes leading batch axes,
so one call detects a whole chunk of keyframes (the JAX package vmaps).

The score is the JAX package's sum-based approximation of OpenCV's FAST
response; on integer-valued images every term is an integer, so the score,
the cell argmax and the keypoints are exact whatever the summation order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["FastGridResult", "fast_grid_detect", "fast_score", "FAST_OFFSETS"]

# Bresenham circle of radius 3 (the FAST-16 ring), clockwise from 12 o'clock, as (dx, dy)
FAST_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)


class FastGridResult(NamedTuple):
    uv: torch.Tensor  # (..., C, 2) pixel coordinates of the best corner per cell
    response: torch.Tensor  # (..., C)
    valid: torch.Tensor  # (..., C) bool


def _ring_planes(img: torch.Tensor) -> torch.Tensor:
    """(..., 16, H, W): the 16 ring intensities of every pixel, the image
    shifted by each offset with its edge replicated."""
    H, W = img.shape[-2:]
    ys = torch.arange(H, device=img.device)
    xs = torch.arange(W, device=img.device)
    planes = []
    for dx, dy in FAST_OFFSETS:
        rows = torch.clamp(ys + dy, 0, H - 1)
        cols = torch.clamp(xs + dx, 0, W - 1)
        planes.append(img[..., rows, :][..., cols])
    return torch.stack(planes, dim=-3)


def _ring_stack(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 16) ring intensities, the JAX package's layout."""
    return _ring_planes(img).movedim(-3, -1)


def fast_score(img: torch.Tensor, threshold: float = 10.0, arc: int = 9) -> torch.Tensor:
    """Dense FAST-9/16 response (..., H, W); 0 where not a corner."""
    ring = _ring_planes(img)
    center = img.unsqueeze(-3)
    brighter = ring > center + threshold
    darker = ring < center - threshold

    def contiguous(mask):  # (..., 16, H, W) -> (..., H, W): any arc of `arc` set
        m = torch.cat([mask, mask[..., : arc - 1, :, :]], dim=-3)
        return m.unfold(-3, arc, 1).all(dim=-1).any(dim=-3)

    diff = ring - center
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    score_b = torch.where(brighter, diff - threshold, zero).sum(dim=-3)
    score_d = torch.where(darker, -diff - threshold, zero).sum(dim=-3)
    return torch.where(contiguous(brighter), score_b, zero) + torch.where(contiguous(darker), score_d, zero)


def fast_grid_detect(img: torch.Tensor, depth: torch.Tensor, threshold: float = 10.0, cell: int = 30,
                     min_depth: float = 0.1, border: int = 16) -> FastGridResult:
    """FAST, the depth mask, the border, and an argmax per grid cell: one
    candidate per cell with a validity mask. ``img`` and ``depth`` are
    (..., H, W)."""
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    score = fast_score(img, threshold)
    dm = torch.isfinite(depth) & (depth > min_depth)
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    inb = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    score = torch.where(dm & inb, score, torch.zeros((), dtype=score.dtype, device=score.device))

    nr, nc = H // cell, W // cell
    crop = score[..., : nr * cell, : nc * cell]
    cells = crop.reshape(*lead, nr, cell, nc, cell).transpose(-3, -2).reshape(*lead, nr * nc, cell * cell)
    best = torch.argmax(cells, dim=-1)  # the first maximum, as jnp.argmax
    resp = torch.take_along_dim(cells, best[..., None], dim=-1)[..., 0]
    cy = best // cell
    cx = best % cell
    ci = torch.arange(nr * nc, device=img.device)
    u = (ci % nc) * cell + cx
    v = (ci // nc) * cell + cy
    uv = torch.stack([u, v], dim=-1).to(img.dtype)
    return FastGridResult(uv=uv, response=resp, valid=resp > 0.0)
