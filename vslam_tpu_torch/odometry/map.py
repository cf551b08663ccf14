"""Sliding-window map of frames, keyframes and landmarks (host registry).

A copy of `vslam_tpu.odometry.map` (numpy only); here a HostFrame's
`frame` and `level_data` hold the port's tensors, unbatched (leaves
(H, W) and (P, ...)).

Rebuild of reference `odometry/src/mapping/Map.{h,cpp}`: deques of the last 7
frames / 7 keyframes (`Map.cpp:19`), a landmark dictionary, and pose/point
write-back used by the bundle-adjustment backend (`Map.cpp:96-129`).

The map is host-side bookkeeping; the heavy per-frame tensors live on device
inside each HostFrame's `frame` and are dropped automatically when a
frame falls out of the window.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from ..core.frame import Frame

__all__ = ["HostFrame", "Landmark", "Map"]

_frame_ids = itertools.count()
_point_ids = itertools.count()


@dataclasses.dataclass
class Landmark:
    """3-D map point with observing-feature bookkeeping (reference Point3D,
    `core/src/Point3D.{h,cpp}`)."""

    position: np.ndarray  # (3,) world
    observations: Dict[int, int] = dataclasses.field(default_factory=dict)
    # frame_id -> feature index within that frame's feature set
    id: int = dataclasses.field(default_factory=lambda: next(_point_ids))


@dataclasses.dataclass
class HostFrame:
    """Host wrapper around the device Frame: pose chain in f64 numpy,
    timestamp in integer nanoseconds (reference Timestamp, types.h:38)."""

    frame: Frame
    t_ns: int
    pose: np.ndarray  # world -> cam, 4x4 f64
    cov: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(6))
    id: int = dataclasses.field(default_factory=lambda: next(_frame_ids))
    # feature data (filled by features.tracking for keyframes)
    keypoints: Optional[np.ndarray] = None  # (N, 2) pixel coords
    descriptors: Optional[np.ndarray] = None  # (N, D)
    kp_depth: Optional[np.ndarray] = None  # (N,)
    kp_landmark: Optional[np.ndarray] = None  # (N,) landmark id or -1
    # cached per-level alignment precompute (ic.precompute_frame output),
    # filled at frame build time; reused every time this frame serves as an
    # alignment reference (the steepest-descent rows are constant per frame,
    # InverseCompositional.cpp:50-59)
    level_data: Optional[tuple] = None


class Map:
    def __init__(self, max_frames: int = 7, max_keyframes: int = 7):
        self._frames: Deque[HostFrame] = deque(maxlen=max_frames)
        self._keyframes: Deque[HostFrame] = deque(maxlen=max_keyframes)
        self._points: Dict[int, Landmark] = {}
        # packed position store indexed directly by landmark id: keeps the
        # per-frame visibility/candidate paths free of per-landmark Python
        # loops (ids are monotonic; the array grows by doubling)
        self._pos = np.full((64, 3), np.nan, np.float64)

    def _store_position(self, pid: int, position: np.ndarray) -> None:
        if pid >= len(self._pos):
            cap = len(self._pos)
            while cap <= pid:
                cap *= 2
            grown = np.full((cap, 3), np.nan, np.float64)
            grown[: len(self._pos)] = self._pos
            self._pos = grown
        self._pos[pid] = position

    def positions_lookup(self, pids: np.ndarray):
        """Vectorized landmark-position fetch: (positions (N, 3), ok (N,)).
        Unknown/negative ids return ok=False rows."""
        pids = np.asarray(pids, np.int64)
        inb = (pids >= 0) & (pids < len(self._pos))
        rows = np.where(inb, pids, 0)
        pos = self._pos[rows]
        ok = inb & np.isfinite(pos[:, 0])
        return pos, ok

    @property
    def max_keyframes(self) -> int:
        """Keyframe window size; effectively unbounded for maxlen=None
        (consumers trim reference lists with this — an unbounded map must
        not silently narrow them)."""
        m = self._keyframes.maxlen
        return int(m) if m is not None else (1 << 30)

    def insert(self, frame: HostFrame, is_keyframe: bool = False):
        self._frames.appendleft(frame)
        if is_keyframe:
            self._keyframes.appendleft(frame)

    def last_frame(self) -> Optional[HostFrame]:
        return self._frames[0] if self._frames else None

    def last_kf(self) -> Optional[HostFrame]:
        return self._keyframes[0] if self._keyframes else None

    def frames(self) -> List[HostFrame]:
        return list(self._frames)

    def keyframes(self) -> List[HostFrame]:
        return list(self._keyframes)

    def points(self) -> List[Landmark]:
        return list(self._points.values())

    def point(self, pid: int) -> Optional[Landmark]:
        return self._points.get(pid)

    def insert_points(self, points: List[Landmark]):
        for p in points:
            self._points[p.id] = p
            self._store_position(p.id, p.position)

    def update_pose(self, frame_id: int, pose: np.ndarray, cov: Optional[np.ndarray] = None):
        for f in itertools.chain(self._keyframes, self._frames):
            if f.id == frame_id:
                f.pose = np.asarray(pose, np.float64)
                if cov is not None:
                    f.cov = cov
                return
        raise KeyError(f"Frame not part of map: {frame_id}")

    def update_poses(self, poses: Dict[int, np.ndarray]):
        for fid, p in poses.items():
            self.update_pose(fid, p)

    def update_points(self, points: Dict[int, np.ndarray]):
        for pid, pos in points.items():
            if pid not in self._points:
                raise KeyError(f"Point not part of map: {pid}")
            self._points[pid].position = np.asarray(pos, np.float64)
            self._store_position(pid, self._points[pid].position)
