"""Carry JAX-package state into the port.

The port has no weights; what crosses over is state: frame pyramids,
per-level interest-point data, cameras, poses and the alignment config.
These functions take the numpy leaves of a `vslam_tpu` pytree (the caller
runs `np.asarray` on the JAX side; this module never sees JAX) and build the
port's types on the device named, CUDA when none is (`core.device.resolve`).
Containers are read by field name, so any object with the JAX NamedTuple's
fields works.
"""

from __future__ import annotations

import numpy as np
import torch

from .alignment.ic import AlignmentConfig, ICLevelData
from .ba.bundle_adjustment import BaProblem
from .ba.pose_graph import PoseGraph
from .core.camera import Camera
from .core.device import resolve
from .core.frame import Frame
from .core.se3 import SE3
from .kalman.ekf_se3 import EkfState
from .odometry.sequential import SequentialConfig
from .solvers.gauss_newton import SolverConfig
from .solvers.loss import LossConfig

__all__ = [
    "frame_from_numpy",
    "level_data_from_numpy",
    "level_data_tuple_from_numpy",
    "camera_from_numpy",
    "se3_from_numpy",
    "ekf_state_from_numpy",
    "alignment_config_from_fields",
    "sequential_config_from_fields",
    "ba_problem_from_numpy",
    "pose_graph_from_numpy",
]


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x, copy=True), dtype=dtype, device=resolve(device))


def camera_from_numpy(cam, device=None) -> Camera:
    return Camera(*(_t(getattr(cam, k), device, torch.float32) for k in Camera._fields))


def se3_from_numpy(g, device=None) -> SE3:
    return SE3(_t(g.R, device, torch.float32), _t(g.t, device, torch.float32))


def frame_from_numpy(frame, device=None) -> Frame:
    def levels(name):
        return tuple(_t(x, device, torch.float32) for x in getattr(frame, name))

    return Frame(
        intensity=levels("intensity"),
        depth=levels("depth"),
        dIx=levels("dIx"),
        dIy=levels("dIy"),
        cameras=tuple(camera_from_numpy(c, device) for c in frame.cameras),
        pose=se3_from_numpy(frame.pose, device),
    )


def level_data_from_numpy(data, device=None) -> ICLevelData:
    return ICLevelData(
        pcl=_t(data.pcl, device, torch.float32),
        J=_t(data.J, device, torch.float32),
        templ=_t(data.templ, device, torch.float32),
        mask=_t(data.mask, device, torch.bool),
        n_constraints=_t(data.n_constraints, device, torch.float32),
    )


def level_data_tuple_from_numpy(levels, device=None):
    """A per-level tuple of ICLevelData (`precompute_frame`'s result)."""
    return tuple(level_data_from_numpy(d, device) for d in levels)


def ekf_state_from_numpy(ekf, device=None) -> EkfState:
    return EkfState(
        pose=se3_from_numpy(ekf.pose, device),
        velocity=_t(ekf.velocity, device, torch.float32),
        P=_t(ekf.P, device, torch.float32),
        Q=_t(ekf.Q, device, torch.float32),
    )


def alignment_config_from_fields(d: dict) -> AlignmentConfig:
    """Rebuild the port's AlignmentConfig from `dataclasses.asdict` of the
    JAX package's config (nested SolverConfig and LossConfig included)."""
    d = dict(d)
    d["solver"] = SolverConfig(**d["solver"])
    d["loss"] = LossConfig(**d["loss"])
    return AlignmentConfig(**d)


def sequential_config_from_fields(d: dict) -> SequentialConfig:
    """Rebuild the port's SequentialConfig from `dataclasses.asdict` of the
    JAX package's config (the nested AlignmentConfig included)."""
    d = dict(d)
    d["alignment"] = alignment_config_from_fields(d["alignment"])
    return SequentialConfig(**d)


def ba_problem_from_numpy(p, device=None) -> BaProblem:
    """A bundle-adjustment problem (`vslam_tpu.ba.bundle_adjustment.BaProblem`'s
    fields); indices become int64, a missing obs_z stays None."""
    f32 = lambda x: _t(x, device, torch.float32)  # noqa: E731
    i64 = lambda x: _t(x, device, torch.int64)  # noqa: E731
    bool_ = lambda x: _t(x, device, torch.bool)  # noqa: E731
    return BaProblem(poses=se3_from_numpy(p.poses, device), pose_mask=bool_(p.pose_mask), points=f32(p.points),
                     point_mask=bool_(p.point_mask), obs_frame=i64(p.obs_frame), obs_point=i64(p.obs_point),
                     obs_uv=f32(p.obs_uv), obs_mask=bool_(p.obs_mask), fx=f32(p.fx), fy=f32(p.fy), cx=f32(p.cx),
                     cy=f32(p.cy), obs_z=None if p.obs_z is None else f32(p.obs_z))


def pose_graph_from_numpy(g, device=None) -> PoseGraph:
    """A pose graph (`vslam_tpu.ba.pose_graph.PoseGraph`'s fields)."""
    return PoseGraph(poses=se3_from_numpy(g.poses, device), edge_i=_t(g.edge_i, device, torch.int64),
                     edge_j=_t(g.edge_j, device, torch.int64), edge_rel=se3_from_numpy(g.edge_rel, device),
                     edge_info=_t(g.edge_info, device, torch.float32), edge_mask=_t(g.edge_mask, device, torch.bool))
