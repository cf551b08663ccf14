"""SE(3) pose with its 6x6 twist covariance, and its composition.

Port of `vslam_tpu.core.pose_cov` (reference `PoseWithCovariance`,
`core/src/PoseWithCovariance.h:23-51`, `.cpp:18-28`). Leaves may carry
leading batch axes: pose (..., 3, 3) / (..., 3), covariance (..., 6, 6).

- ``compose`` is the reference's transport: the block-diagonal rotation
  ``R6 C R6^T`` with ``R6 = diag(R, R)`` (`PoseWithCovariance.cpp:19-28`).
- ``compose_adjoint`` transports by the full SE(3) adjoint ``Ad C Ad^T``,
  which couples rotation uncertainty into translation through the lever arm.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import se3
from .se3 import SE3

__all__ = ["PoseWithCovariance", "compose", "compose_adjoint"]


class PoseWithCovariance(NamedTuple):
    pose: SE3
    cov: torch.Tensor  # (..., 6, 6) twist covariance

    def mean(self) -> torch.Tensor:
        """Twist log of the pose (`PoseWithCovariance.h:42`)."""
        return se3.log(self.pose)

    def inverse(self) -> "PoseWithCovariance":
        """Inverse pose, covariance unchanged, as the reference does
        (`PoseWithCovariance.h:43`)."""
        return PoseWithCovariance(se3.inverse(self.pose), self.cov)


def _rot6(R: torch.Tensor) -> torch.Tensor:
    Z = torch.zeros_like(R)
    return torch.cat([torch.cat([R, Z], dim=-1), torch.cat([Z, R], dim=-1)], dim=-2)


def _transport(M: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    return M @ cov @ M.transpose(-1, -2)


def compose(p1: SE3, p0: PoseWithCovariance) -> PoseWithCovariance:
    """``p1 * p0`` with the covariance rotated block-diagonally (the
    reference's semantics)."""
    return PoseWithCovariance(se3.compose(p1, p0.pose), _transport(_rot6(p1.R), p0.cov))


def compose_adjoint(p1: SE3, p0: PoseWithCovariance) -> PoseWithCovariance:
    """``p1 * p0`` with the full adjoint transport ``Ad(p1) C Ad(p1)^T``."""
    return PoseWithCovariance(se3.compose(p1, p0.pose), _transport(se3.adjoint(p1), p0.cov))
