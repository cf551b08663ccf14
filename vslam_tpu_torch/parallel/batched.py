"""Batched frame-pair alignment — the throughput path (port of
`vslam_tpu.parallel.batched.align_pairs`).

The JAX package aligns B independent pairs with `vmap`; here B is the
leading axis of every tensor and one `ic.align` call serves the batch, so
the whole-level GN kernel runs once per pyramid level for all B pairs. The
EKF tracking step and the device-mesh functions are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..alignment import ic
from ..alignment.ic import AlignmentConfig
from ..core.frame import Frame
from ..core.se3 import SE3
from ..utils.tree import tree_map

__all__ = ["align_pairs"]


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
