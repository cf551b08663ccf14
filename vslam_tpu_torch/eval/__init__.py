"""Trajectory evaluation (port of `vslam_tpu.eval`; the metrics so far)."""

from . import metrics

__all__ = ["metrics"]
