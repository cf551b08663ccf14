"""EKF with a constant-velocity SE(3) motion model, on torch tensors.

Port of `vslam_tpu.kalman.ekf_se3` (reference `EKFConstantVelocitySE3`):
state [pose xi (6); body velocity twist (6)], prediction pose . exp(v dt),
measurement a velocity twist (`MotionPrediction.cpp:57-81`). The JAX
package's deliberate deviations are kept: the intended process Jacobian
F = [[Ad(exp(-v dt)), dt I], [0, I]] and consistent seconds. Every function
broadcasts over leading axes (one filter per pair or per sequence); the
JAX functions are the one-filter case.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core import se3
from ..core.se3 import SE3

__all__ = ["EkfState", "init", "predict", "update", "measurement_noise_from_cov"]


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _t(M: torch.Tensor) -> torch.Tensor:
    return M.transpose(-1, -2)


def measurement_noise_from_cov(cov: torch.Tensor, scale: float = 1e-2) -> torch.Tensor:
    """Measurement noise from an aligner covariance (A^-1): only its
    structure is trusted, normalized to mean diagonal ``scale``; degenerate
    inputs fall back to scale * I (the reference feeds I here,
    MotionPrediction.cpp:84). Kept SPD under f32 roundoff."""
    eye = _eye(6, cov)
    tr = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1) / 6.0
    ok = torch.isfinite(tr) & (tr > 0.0) & torch.isfinite(cov).all(dim=-1).all(dim=-1)
    ratio = scale / torch.where(ok, tr, torch.ones_like(tr))
    R = torch.where(ok[..., None, None], cov * ratio[..., None, None], eye * scale)
    return 0.5 * (R + _t(R)) + eye * (scale * 1e-3)


class EkfState(NamedTuple):
    pose: SE3  # world -> camera
    velocity: torch.Tensor  # (..., 6) body twist, per second
    P: torch.Tensor  # (..., 12, 12) covariance of [d pose; d velocity]
    Q: torch.Tensor  # (..., 12, 12) process noise per second


def init(
    pose: Optional[SE3] = None,
    process_noise: float = 1e-2,
    dtype=torch.float32,
    device=None,
) -> EkfState:
    """A filter at ``pose`` (the identity on ``device``, CUDA unless named,
    by default) with zero velocity; the leaves get the pose's leading axes
    and device."""
    if pose is None:
        pose = se3.identity(dtype=dtype, device=device)
    batch = pose.t.shape[:-1]
    eye = _eye(12, pose.t)
    return EkfState(
        pose=pose,
        velocity=pose.t.new_zeros(*batch, 6),
        P=eye.expand(*batch, 12, 12).clone(),
        Q=(eye * process_noise).expand(*batch, 12, 12).clone(),
    )


def _process_jacobian(v_dt: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """F for pose' = pose . exp(v dt): old-pose perturbations carried by
    Ad(exp(-v dt)), velocity entering with gain dt."""
    step_inv = se3.inverse(se3.exp(v_dt))
    F = v_dt.new_zeros(*v_dt.shape[:-1], 12, 12)
    F[..., :6, :6] = se3.adjoint(step_inv)
    F[..., :6, 6:] = dt[..., None, None] * _eye(6, v_dt)
    F[..., 6:, 6:] = _eye(6, v_dt)
    return F


def predict(state: EkfState, dt) -> Tuple[EkfState, SE3]:
    """Advance the filter by dt seconds (a tensor of the leading shape, or a
    number); returns (new_state, predicted pose)."""
    v = state.velocity
    dt = torch.as_tensor(dt, dtype=v.dtype, device=v.device).expand(v.shape[:-1])
    v_dt = v * dt[..., None]
    pose_new = se3.compose(state.pose, se3.exp(v_dt))
    F = _process_jacobian(v_dt, dt)
    P_new = F @ state.P @ _t(F) + state.Q * torch.clamp(dt, min=0.0)[..., None, None]
    return EkfState(pose_new, v, P_new, state.Q), pose_new


def update(state: EkfState, v_measured: torch.Tensor, R: torch.Tensor) -> EkfState:
    """Velocity-twist measurement update (H = [0, I]); the pose moves only
    through the cross-covariance (EKFConstantVelocitySE3.cpp:48-51)."""
    v = state.velocity
    H = torch.cat([v.new_zeros(6, 6), _eye(6, v)], dim=1)
    y = v_measured - v
    S = state.P[..., 6:, 6:] + R
    K = state.P @ _t(H) @ torch.linalg.inv_ex(S).inverse  # (..., 12, 6)
    dx = (K @ y[..., None])[..., 0]
    pose_new = se3.compose(state.pose, se3.exp(dx[..., :6]))
    P_new = (_eye(12, v) - K @ H) @ state.P
    # re-symmetrize: (I - KH) P loses symmetry in f32 over many cycles
    P_new = 0.5 * (P_new + _t(P_new))
    return EkfState(pose_new, v + dx[..., 6:], P_new, state.Q)
