"""Odometry front ends (port of `vslam_tpu.odometry`; the sequential scan so far)."""

from . import sequential
from .sequential import SequentialConfig, SequentialOdometry

__all__ = ["sequential", "SequentialConfig", "SequentialOdometry"]
