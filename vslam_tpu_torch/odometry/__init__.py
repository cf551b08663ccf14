"""Odometry front ends (port of `vslam_tpu.odometry`): the sequential scan,
the per-frame host pipeline (`odometry.pipeline`) and its parts, and the
mapping backends (`odometry.sequential_mapping`, `odometry.graph_backend`)."""

from . import keyframe, map as map_mod, motion_model, odometry, sequential, trajectory
from .map import HostFrame, Landmark, Map
from .odometry import OdometryRgbd
from .sequential import SequentialConfig, SequentialOdometry
from .trajectory import Trajectory

__all__ = [
    "keyframe",
    "map_mod",
    "motion_model",
    "odometry",
    "sequential",
    "trajectory",
    "HostFrame",
    "Landmark",
    "Map",
    "OdometryRgbd",
    "SequentialConfig",
    "SequentialOdometry",
    "Trajectory",
]
