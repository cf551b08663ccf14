"""Kalman filters (port of `vslam_tpu.kalman`)."""

from . import ekf_se3, filter
from .ekf_se3 import EkfState
from .filter import KalmanState

__all__ = ["ekf_se3", "filter", "EkfState", "KalmanState"]
