"""Timestamped pose trajectory (host-side, f64).

A copy of `vslam_tpu.odometry.trajectory` (numpy only).

Rebuild of reference `core/src/Trajectory.{h,cpp}`: a timestamp -> pose map
with constant-velocity interpolation (`Trajectory.cpp:48-70`) and
motion-between queries. Host numpy: the absolute pose chain is unbounded and
belongs in f64 on the host, not on the accelerator.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..core import lie_np

__all__ = ["Trajectory"]


class Trajectory:
    def __init__(self, poses: Optional[Dict[int, np.ndarray]] = None):
        # t_ns -> pose 4x4, stored exactly as appended. The class itself is
        # convention-agnostic; throughout this codebase the pipeline appends
        # WORLD->CAMERA poses (reference Frame::pose convention), and the
        # TUM writer inverts to camera->world at the file boundary
        # (eval/evaluate.py). motion_between/interpolation are
        # convention-covariant, so they are correct either way.
        self._poses: Dict[int, np.ndarray] = dict(poses or {})
        self._covs: Dict[int, np.ndarray] = {}

    def append(self, t_ns: int, pose: np.ndarray, cov: Optional[np.ndarray] = None):
        self._poses[int(t_ns)] = np.asarray(pose, dtype=np.float64)
        if cov is not None:
            self._covs[int(t_ns)] = np.asarray(cov, dtype=np.float64)

    def __len__(self) -> int:
        return len(self._poses)

    @property
    def timestamps(self):
        return sorted(self._poses.keys())

    def items(self):
        return sorted(self._poses.items())

    def cov_at(self, t_ns: int) -> Optional[np.ndarray]:
        return self._covs.get(int(t_ns))

    def pose_at(self, t_ns: int, interpolate: bool = True) -> np.ndarray:
        t_ns = int(t_ns)
        if t_ns in self._poses:
            return self._poses[t_ns]
        if not interpolate:
            raise KeyError(f"No pose at {t_ns}")
        return self._interpolate_at(t_ns)

    def motion_between(self, t0: int, t1: int, interpolate: bool = True) -> np.ndarray:
        """Relative pose p1 . p0^-1 (Trajectory.cpp:64-70)."""
        return lie_np.relative(self.pose_at(t0, interpolate), self.pose_at(t1, interpolate))

    def _interpolate_at(self, t_ns: int) -> np.ndarray:
        """Constant-velocity interpolation between the bracketing poses
        (Trajectory.cpp:48-63); clamps at the boundaries instead of
        extrapolating past the ends."""
        ts = self.timestamps
        if not ts:
            raise KeyError("Empty trajectory")
        if t_ns <= ts[0]:
            return self._poses[ts[0]]
        if t_ns >= ts[-1]:
            return self._poses[ts[-1]]
        idx = np.searchsorted(np.asarray(ts), t_ns)
        t0, t1 = ts[idx - 1], ts[idx]
        p0, p1 = self._poses[t0], self._poses[t1]
        speed = lie_np.log(lie_np.relative(p0, p1)) / float(t1 - t0)
        d = lie_np.exp(speed * float(t_ns - t0))
        return d @ p0
