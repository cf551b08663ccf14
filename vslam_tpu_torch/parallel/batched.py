"""Batched frame-pair alignment — the throughput path (port of
`vslam_tpu.parallel.batched.align_pairs`).

The JAX package aligns B independent pairs with `vmap`; here B is the
leading axis of every tensor and one `ic.align` call serves the batch, so
the whole-level GN kernel runs once per pyramid level for all B pairs.
`tracking_step` adds a per-pair EKF around it. The device-mesh functions
wait for the multi-GPU item of ROADMAP.md.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..alignment import ic
from ..alignment.ic import AlignmentConfig
from ..core import se3
from ..core.frame import Frame
from ..core.se3 import SE3
from ..kalman import ekf_se3
from ..utils.tree import tree_map

__all__ = ["align_pairs", "tracking_step"]


def align_pairs(
    ref: Frame,  # leaves batched (B, ...)
    cur: Frame,  # leaves batched (B, ...)
    rel_init: SE3,  # (B, 3, 3), (B, 3)
    x_pred: Optional[torch.Tensor],  # (B, 6) prior means, or None (zeros)
    cfg: AlignmentConfig,
) -> Tuple[SE3, torch.Tensor, torch.Tensor]:
    """Coarse-to-fine alignment of B independent pairs, each against its
    one reference frame. Returns (rel (B,), cov (B, 6, 6), valid (B,)).
    As in the JAX function, a missing x_pred becomes zeros, so the prior
    (when cfg.include_prior) pulls toward zero motion."""
    if x_pred is None:
        x_pred = rel_init.t.new_zeros(rel_init.t.shape[0], 6)
    ref_f = tree_map(lambda x: x[:, None], ref)  # frame axis F = 1
    rel, cov, valid = ic.align(
        ref_f, cur, SE3(rel_init.R[:, None], rel_init.t[:, None]), x_pred[:, None], cfg
    )
    return SE3(rel.R[:, 0], rel.t[:, 0]), cov, valid


def tracking_step(
    ekf: ekf_se3.EkfState,  # per-pair filters, leaves (B, ...)
    ref: Frame,
    cur: Frame,
    dt: torch.Tensor,  # (B,) seconds
    cfg: AlignmentConfig,
) -> Tuple[ekf_se3.EkfState, SE3, torch.Tensor]:
    """One tracking step for B sequences: EKF predict, alignment with the
    predicted relative motion exp(v dt) as init and prior mean, then the
    velocity update log(rel) / dt with the aligner's covariance structure as
    measurement noise, kept only where the alignment is valid. Returns
    (ekf, rel (B,), valid (B,))."""
    ekf_pred, _ = ekf_se3.predict(ekf, dt)
    rel_pred = se3.exp(ekf.velocity * dt[:, None])
    rel, cov, valid = align_pairs(ref, cur, rel_pred, se3.log(rel_pred), cfg)
    v_meas = se3.log(rel) / torch.clamp(dt, min=1e-6)[:, None]
    R = ekf_se3.measurement_noise_from_cov(cov, scale=1e-2)
    new = ekf_se3.update(ekf_pred, v_meas, R)
    ekf_new = tree_map(
        lambda a, b: torch.where(valid.view(-1, *([1] * (a.dim() - 1))), a, b), new, ekf_pred
    )
    return ekf_new, rel, valid
