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
