"""Visual-odometry front end (reference `odometry/src/Odometry.{h,cpp}`).

Port of `vslam_tpu.odometry.odometry`: host numpy around the port's
`RgbdAligner`. `OdometryIcp` takes its aligner as an argument (any object
with the aligner's `align(refs, ref_poses, cur, pred)`).

`OdometryRgbd.update` aligns the incoming frame against {last keyframe, last
frame} jointly by default (Odometry.cpp:31-62), derives the speed twist, and
falls back to the motion-predicted pose when alignment fails (the reference
catches the solver's exception; here the aligner returns a validity flag —
graceful degradation without host exceptions).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..alignment.aligner import RgbdAligner
from ..core import lie_np
from .map import HostFrame, Map

__all__ = ["OdometryRgbd", "OdometryIcp"]

_NS = 1e9


class OdometryRgbd:
    def __init__(
        self,
        aligner: RgbdAligner,
        slam_map: Map,
        include_key_frame: bool = True,
        track_key_frame: bool = False,
    ):
        self._aligner = aligner
        self._map = slam_map
        self._include_key_frame = include_key_frame
        self._track_key_frame = track_key_frame
        self._pose: Optional[np.ndarray] = None
        self._cov = np.eye(6)
        self._speed = np.zeros(6)

    @property
    def pose(self) -> Optional[np.ndarray]:
        return self._pose

    @property
    def cov(self) -> np.ndarray:
        return self._cov

    @property
    def speed(self) -> np.ndarray:
        return self._speed

    def select_refs(self):
        """Reference-frame selection for the incoming frame: {last keyframe,
        last frame} jointly by default (Odometry.cpp:31-62). Returns
        (last_frame_or_None, ref_hosts) so the caller can run the alignment
        itself (the pipeline's fused build+align step) or fall through to
        :meth:`update`."""
        last = self._map.last_frame()
        if last is None:
            return None, []
        kf = self._map.last_kf()
        if self._include_key_frame and kf is not None and kf is not last:
            return last, [kf, last]
        if self._track_key_frame and kf is not None:
            return last, [kf]
        return last, [last]

    def commit(self, frame: HostFrame, pose, cov, ok: bool, last: Optional[HostFrame]) -> None:
        """Fold an alignment result into the odometry state: accept pose+cov
        and derive the speed twist, or keep the motion-predicted pose on
        failure (Odometry.cpp:52-56 catches the solver's exception; here the
        aligner returned ok=False)."""
        if last is None:
            # first frame initializes at its (predicted/initial) pose
            self._pose = frame.pose.copy()
            self._speed = np.zeros(6)
            return
        if ok:
            self._pose, self._cov = pose, cov
            dt = (frame.t_ns - last.t_ns) / _NS
            if dt > 0:
                self._speed = lie_np.log(lie_np.relative(last.pose, pose)) / dt
        else:
            self._pose = frame.pose.copy()
            self._speed = np.zeros(6)

    def update(self, frame: HostFrame) -> None:
        last, ref_hosts = self.select_refs()
        if last is None:
            self.commit(frame, None, None, False, None)
            return
        refs = [h.frame for h in ref_hosts]
        ref_poses = [h.pose for h in ref_hosts]
        # cached per-frame precompute (filled at frame build): skips the
        # per-level interest-point pass inside the aligner
        ref_data = [h.level_data for h in ref_hosts]

        pose, cov, ok = self._aligner.align(
            refs, ref_poses, frame.frame, frame.pose, ref_data=ref_data
        )
        self.commit(frame, pose, cov, ok, last)


class OdometryIcp:
    """Geometric-odometry front end using the dense projective ICP aligner
    (reference OdometryIcp, Odometry.cpp:65-87): aligns each frame against
    the last frame only."""

    def __init__(self, aligner, slam_map: Map):
        self._aligner = aligner
        self._map = slam_map
        self._pose: Optional[np.ndarray] = None
        self._cov = np.eye(6)
        self._speed = np.zeros(6)

    @property
    def pose(self):
        return self._pose

    @property
    def cov(self):
        return self._cov

    @property
    def speed(self):
        return self._speed

    def update(self, frame: HostFrame) -> None:
        last = self._map.last_frame()
        if last is None:
            self._pose = frame.pose.copy()
            self._speed = np.zeros(6)
            return
        pose, cov, ok = self._aligner.align([last.frame], [last.pose], frame.frame, frame.pose)
        if ok:
            self._pose, self._cov = pose, cov
            dt = (frame.t_ns - last.t_ns) / _NS
            if dt > 0:
                self._speed = lie_np.log(lie_np.relative(last.pose, pose)) / dt
        else:
            self._pose = frame.pose.copy()
            self._speed = np.zeros(6)
