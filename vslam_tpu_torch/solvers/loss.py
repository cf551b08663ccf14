"""Robust M-estimator losses and residual scalers on torch tensors.

Port of `vslam_tpu.solvers.loss` (reference `least_squares/src/{Loss,
Scaler}.cpp`). Every scale function reduces over the last axis; leading axes
are independent rows (the port's pair and frame axes), so one call scales
all (B, F) residual vectors of a level at once.

Reference quirks kept, as in the JAX package:
- Huber's outlier weight is sign(r)/r = 1/|r| (Loss.cpp:65-72), not c/|r|;
- the median scaler's spread is sqrt(sum|r - med| / (n - 1)), an L1 pseudo-
  std (Scaler.cpp:21-35);
- tdistribution always pairs with its own fixed-point scale, whatever
  ``scaler`` says (NodeMapping.cpp:73-84);
- scales run over the whole interest set, invisible points entering with
  r = 0 (InverseCompositional.cpp:105-137).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.image import masked_median

__all__ = [
    "LossConfig",
    "Scale",
    "TUKEY_C",
    "compute_scale",
    "compute_weights",
    "tukey_weight",
    "huber_weight",
    "t_dist_weight",
]

TUKEY_C = 4.6851  # 95% asymptotic efficiency constant (Loss.h:70-72)


class Scale(NamedTuple):
    offset: torch.Tensor  # (...,) one per row
    scale: torch.Tensor


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Mirrors the reference's `loss.*` parameter tree (NodeMapping.cpp:52-84);
    same fields and defaults as the JAX package."""

    function: str = "None"  # None | Tukey | Huber | tdistribution
    huber_c: float = 1.345
    tdistribution_v: float = 5.0
    # Tukey/Huber scale: "reference" (the L1 pseudo-std above), "mad"
    # (1.4826 * median|r - med|) or "mean" (Scaler.cpp:37-47)
    scaler: str = "reference"  # reference | mad | mean


def tukey_weight(r: torch.Tensor, c: float = TUKEY_C) -> torch.Tensor:
    """(1 - (r/c)^2)^2 inside the cutoff, 0 outside (Loss.cpp:49-63)."""
    rc = r / c
    w = torch.square(1.0 - rc * rc)
    return torch.where(torch.abs(r) < c, w, torch.zeros_like(w))


def huber_weight(r: torch.Tensor, c: float = 1.345) -> torch.Tensor:
    """1 inside, 1/|r| outside (Loss.cpp:65-72)."""
    inlier = torch.abs(r) < c
    safe = torch.where(inlier, torch.ones_like(r), r)
    return torch.where(inlier, torch.ones_like(r), 1.0 / torch.abs(safe))


def t_dist_weight(r: torch.Tensor, v: float = 5.0) -> torch.Tensor:
    """(v + 1) / (v + r^2) (Loss.cpp:92)."""
    return (v + 1.0) / (v + r * r)


def _count(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.sum(-1).to(like.dtype)


def _median_scale(r: torch.Tensor, mask: torch.Tensor) -> Scale:
    """MedianScaler (Scaler.cpp:21-35): offset median, scale
    sqrt(sum|r - med| / (n - 1)), 1 where that is 0."""
    med = masked_median(r, mask)
    n = _count(mask, r)
    dev = torch.sum(torch.where(mask, torch.abs(r - med[..., None]), torch.zeros_like(r)), dim=-1)
    std = torch.sqrt(dev / torch.clamp(n - 1.0, min=1.0))
    return Scale(med, torch.where(std > 0, std, torch.ones_like(std)))


def _mean_scale(r: torch.Tensor, mask: torch.Tensor) -> Scale:
    """MeanScaler (Scaler.cpp:37-47); an empty row gives offset 0, scale 1."""
    n = _count(mask, r)
    zero = torch.zeros_like(r)
    mean = torch.sum(torch.where(mask, r, zero), dim=-1) / torch.clamp(n, min=1.0)
    dev = torch.sum(torch.where(mask, torch.abs(r - mean[..., None]), zero), dim=-1)
    std = torch.sqrt(dev / torch.clamp(n - 1.0, min=1.0))
    empty = n < 1
    return Scale(
        torch.where(empty, torch.zeros_like(mean), mean),
        torch.where(empty | (std <= 0), torch.ones_like(std), std),
    )


def _t_dist_scale(
    r: torch.Tensor,
    mask: torch.Tensor,
    v: float = 5.0,
    max_iterations: int = 30,
    min_step_size: float = 1e-5,
) -> Scale:
    """ScalerTDistribution (Scaler.cpp:49-67): the fixed point
    sigma^2 <- mean r^2 (v + 1) / (v + r^2 / sigma^2), from sigma = 1, each
    row stopping at its own step <= min_step_size."""
    n = torch.clamp(_count(mask, r), min=1.0)
    r2 = torch.where(mask, r * r, torch.zeros_like(r))
    sigma = torch.ones_like(n)
    active = torch.ones_like(n, dtype=torch.bool)
    for _ in range(max_iterations):
        sigma2 = torch.clamp(sigma * sigma, min=1e-24)
        s = torch.sum(r2 * (v + 1.0) / (v + r2 / sigma2[..., None]), dim=-1)
        sigma_new = torch.sqrt(s / n)
        step = torch.abs(sigma - sigma_new)
        sigma = torch.where(active, sigma_new, sigma)
        active = active & (step > min_step_size)
    return Scale(torch.zeros_like(sigma), torch.clamp(sigma, min=1e-12))


def _mad_scale(r: torch.Tensor, mask: torch.Tensor) -> Scale:
    """1.4826 * median|r - median(r)| (not a reference formula: the
    "mad" scaler); 1 where that is <= 1e-6."""
    med = masked_median(r, mask)
    sigma = 1.4826 * masked_median(torch.abs(r - med[..., None]), mask)
    return Scale(med, torch.where(sigma > 1e-6, sigma, torch.ones_like(sigma)))


def compute_scale(cfg: LossConfig, r: torch.Tensor, mask: torch.Tensor) -> Scale:
    """Residual standardization of each row of ``r`` over ``mask``."""
    if cfg.function in ("Tukey", "Huber"):
        if cfg.scaler == "mad":
            return _mad_scale(r, mask)
        if cfg.scaler == "mean":
            return _mean_scale(r, mask)
        return _median_scale(r, mask)
    if cfg.function == "tdistribution":
        return _t_dist_scale(r, mask, v=cfg.tdistribution_v)
    one = torch.ones(r.shape[:-1], dtype=r.dtype, device=r.device)
    return Scale(torch.zeros_like(one), one)


def compute_weights(cfg: LossConfig, r_scaled: torch.Tensor) -> torch.Tensor:
    if cfg.function == "Tukey":
        return tukey_weight(r_scaled)
    if cfg.function == "Huber":
        return huber_weight(r_scaled, cfg.huber_c)
    if cfg.function == "tdistribution":
        return t_dist_weight(r_scaled, cfg.tdistribution_v)
    return torch.ones_like(r_scaled)
