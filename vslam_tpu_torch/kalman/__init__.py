"""Kalman filters (port of `vslam_tpu.kalman`)."""

from . import ekf_se3, filter
from .ekf_se3 import EkfState

__all__ = ["ekf_se3", "filter", "EkfState"]
