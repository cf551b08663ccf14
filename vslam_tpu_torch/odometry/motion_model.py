"""Motion prediction models (reference `odometry/src/MotionPrediction.{h,cpp}`).

Port of `vslam_tpu.odometry.motion_model`: the string factory and the three
models of the reference's `prediction.model` parameter. NoMotion and
ConstantMotion (twist extrapolation, MotionPrediction.cpp:38-55) are host
numpy; Kalman (MotionPrediction.cpp:57-81) runs the f32 EKF of
`kalman.ekf_se3` on ``device`` (CUDA unless named).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import lie_np
from ..core.device import resolve
from ..core.se3 import SE3
from ..kalman import ekf_se3

__all__ = [
    "MotionPrediction",
    "MotionPredictionNoMotion",
    "MotionPredictionConstant",
    "MotionPredictionKalman",
    "make_motion_prediction",
]

_NS = 1e9


class MotionPrediction:
    def predict(self, t_ns: int) -> np.ndarray:
        raise NotImplementedError

    def update(self, pose: np.ndarray, t_ns: int, cov: Optional[np.ndarray] = None) -> None:
        """``cov`` is the 6x6 covariance of the pose estimate (the aligner's
        A^-1); models that filter use it as measurement noise."""
        raise NotImplementedError

    def speed(self) -> np.ndarray:
        """Current twist estimate [v; w] in 1/s (the reference's
        ``Odometry::speed()``, NodeMapping.cpp:263). Zero for models
        without a velocity state."""
        return np.zeros(6)

    def speed_host(self) -> np.ndarray:
        """Host-cached twist for per-frame display paths: never waits for
        the device. Defaults to speed(), host-side for the host models."""
        return self.speed()


class MotionPredictionNoMotion(MotionPrediction):
    """Prediction = last pose (MotionPrediction.h:36-60)."""

    def __init__(self):
        self._pose = np.eye(4)

    def predict(self, t_ns: int) -> np.ndarray:
        return self._pose.copy()

    def update(self, pose: np.ndarray, t_ns: int, cov: Optional[np.ndarray] = None) -> None:
        self._pose = np.asarray(pose, np.float64)


class MotionPredictionConstant(MotionPrediction):
    """Constant-twist extrapolation: speed = log(rel)/dt, prediction =
    exp(speed dt) . last_pose (MotionPrediction.cpp:38-55)."""

    def __init__(self):
        self._pose = np.eye(4)
        self._speed = np.zeros(6)
        self._t_ns = 0

    def predict(self, t_ns: int) -> np.ndarray:
        dt = (int(t_ns) - self._t_ns) / _NS
        return lie_np.exp(self._speed * dt) @ self._pose

    def update(self, pose: np.ndarray, t_ns: int, cov: Optional[np.ndarray] = None) -> None:
        if int(t_ns) < self._t_ns:
            raise ValueError("New timestamp is older than last one!")
        dt = (int(t_ns) - self._t_ns) / _NS
        if dt > 0 and self._t_ns > 0:
            self._speed = lie_np.log(lie_np.relative(self._pose, pose)) / dt
        self._pose = np.asarray(pose, np.float64)
        self._t_ns = int(t_ns)

    def speed(self) -> np.ndarray:
        return self._speed.copy()


class MotionPredictionKalman(MotionPrediction):
    """EKF-backed prediction (MotionPrediction.cpp:57-81): the measurement is
    the per-second speed twist between consecutive odometry poses."""

    def __init__(self, process_noise: float = 1e-2, measurement_noise: float = 1e-2, device=None):
        self._device = resolve(device)
        self._state = ekf_se3.init(process_noise=process_noise, dtype=torch.float32, device=self._device)
        self._measurement_noise = float(measurement_noise)
        self._R = torch.eye(6, dtype=torch.float32, device=self._device) * measurement_noise
        self._pose = np.eye(4)
        self._t_ns = 0
        self._speed_host = np.zeros(6)  # measured odometry twist (see speed_host)

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=self._device)

    def _se3(self, pose: np.ndarray) -> SE3:
        return SE3(self._f32(pose[:3, :3]), self._f32(pose[:3, 3]))

    @staticmethod
    def _pose_np(g: SE3) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = g.R.detach().cpu().double().numpy()
        T[:3, 3] = g.t.detach().cpu().double().numpy()
        u, _, vt = np.linalg.svd(T[:3, :3])
        T[:3, :3] = u @ vt
        return T

    def predict(self, t_ns: int) -> np.ndarray:
        dt = (int(t_ns) - self._t_ns) / _NS
        _, pose = ekf_se3.predict(self._state, dt)
        return self._pose_np(pose)

    def update(self, pose: np.ndarray, t_ns: int, cov: Optional[np.ndarray] = None) -> None:
        if int(t_ns) < self._t_ns:
            raise ValueError("New timestamp is older than last one!")
        dt = (int(t_ns) - self._t_ns) / _NS
        if dt > 0 and self._t_ns > 0:
            speed = lie_np.log(lie_np.relative(self._pose, pose)) / dt
            self._speed_host = np.asarray(speed, np.float64)
            state, _ = ekf_se3.predict(self._state, dt)
            # re-anchor the filter pose at the measured odometry pose
            state = state._replace(pose=self._se3(pose))
            # measurement noise: the aligner covariance's structure at the
            # default scale when given, else the fixed default (the
            # reference feeds identity, MotionPrediction.cpp:84)
            if cov is not None:
                R = ekf_se3.measurement_noise_from_cov(self._f32(cov), scale=self._measurement_noise)
            else:
                R = self._R
            self._state = ekf_se3.update(state, self._f32(speed), R)
        else:
            self._state = self._state._replace(pose=self._se3(pose))
        self._pose = np.asarray(pose, np.float64)
        self._t_ns = int(t_ns)

    def speed(self) -> np.ndarray:
        return self._state.velocity.detach().cpu().double().numpy()

    def speed_host(self) -> np.ndarray:
        """The measured odometry twist cached at update() time (what the
        reference publishes as the /odom twist, Odometry.cpp:44-50); the
        filtered velocity would wait for the device."""
        return self._speed_host.copy()


def make_motion_prediction(model: str, device=None) -> MotionPrediction:
    """String factory (MotionPrediction.cpp:22-36); unknown names fall back
    to the constant-motion model, as the reference does. ``device`` is the
    Kalman filter's (CUDA unless named)."""
    if model == "NoMotion":
        return MotionPredictionNoMotion()
    if model == "Kalman":
        return MotionPredictionKalman(device=device)
    return MotionPredictionConstant()
