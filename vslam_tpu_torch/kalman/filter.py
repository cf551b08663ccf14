"""Generic linear Kalman filter on torch tensors.

Port of `vslam_tpu.kalman.filter` (reference `KalmanFilter.h:31-86`): the
A(dt) / H(dt) hooks are plain arguments and the state is an explicit
NamedTuple. Every function broadcasts over leading axes, so a batch of
filters advances in one call.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

__all__ = ["KalmanState", "predict", "update"]


class KalmanState(NamedTuple):
    x: torch.Tensor  # (..., N) state mean
    P: torch.Tensor  # (..., N, N) state covariance


def _t(M: torch.Tensor) -> torch.Tensor:
    return M.transpose(-1, -2)


def predict(state: KalmanState, A: torch.Tensor, Q: torch.Tensor) -> KalmanState:
    """x' = A x, P' = A P A^T + Q (KalmanFilter.h:47-58)."""
    x = (A @ state.x[..., None])[..., 0]
    P = A @ state.P @ _t(A) + Q
    return KalmanState(x, P)


def update(
    state: KalmanState, z: torch.Tensor, H: torch.Tensor, R: torch.Tensor
) -> Tuple[KalmanState, torch.Tensor]:
    """Measurement update with gain K = P H^T (H P H^T + R)^-1
    (KalmanFilter.h:59-72). Returns (new_state, innovation). The inverse is
    `linalg.inv_ex`, which does not wait for the device to report a
    singular S."""
    y = z - (H @ state.x[..., None])[..., 0]
    S = H @ state.P @ _t(H) + R
    K = state.P @ _t(H) @ torch.linalg.inv_ex(S).inverse
    x = state.x + (K @ y[..., None])[..., 0]
    n = state.x.shape[-1]
    P = (torch.eye(n, dtype=state.P.dtype, device=state.P.device) - K @ H) @ state.P
    P = 0.5 * (P + _t(P))  # f32 symmetry drift guard (see ekf_se3.update)
    return KalmanState(x, P), y
